"""Seconds a scan in the pipeline's phases that end in a wait for the card
(mesh prep with K1, each model's stages, the fused bdl model), summed over
every scan of the window. They include the waits for the other scans'
kernels on the card."""

PHASES = ("mesh_prep", "fps:stage1_device", "fps:stage2_device", "bdl:fused_device")


def read(records):
    if not records.get("scans"):
        return None
    return sum(records["phase_s"].get(p, 0.0) for p in PHASES) / records["scans"]
