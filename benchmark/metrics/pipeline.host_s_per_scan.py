"""Host seconds a scan in the pipeline's own phase timer
(``TgnInferencePipeline._t``), summed over every scan of the window and
over its host phases: clustering, instancing, the boundary resampling, the
boundary KMeans, the fusion and the label transfer. Under three scans in
flight the phases overlap, so this is host work, not latency."""

PHASES = ("fps:host_centroids", "host_instancing", "host_boundary_resample",
          "host_bdl_kmeans", "host_fusion", "host_1nn_transfer")


def read(records):
    if not records.get("scans"):
        return None
    return sum(records["phase_s"].get(p, 0.0) for p in PHASES) / records["scans"]
