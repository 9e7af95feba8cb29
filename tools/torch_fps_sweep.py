"""K1 (csrc/fps.cu) at every cluster size, on one card.

    python3 tools/torch_fps_sweep.py

Times the FPS kernel through its C entry at the main path's shapes with the
cluster size forced to each of 1, 2, 4, 6, 8, 12 and 16 CTAs per cloud
(CUDA events, mean of 2 calls after one; random normal clouds from a fixed
seed), beside the size the wrapper picks (``ops.kernels.fps.cluster_size``).
Prints one JSON line per shape with the card's nvidia-smi name and power
limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 4, 6, 8, 12, 16)
# B, N, samples, valid points (None: all)
SHAPES = ((1, 106496, 24000, 100489), (1, 84000, 8000, None),
          (1, 24000, 6000, None), (16, 3072, 768, None), (1, 6000, 1500, None))


def main() -> int:
    sys.path[:0] = [str(REPO)]
    import torch

    if not torch.cuda.is_available():
        print("torch_fps_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from toothgroupnetwork_tpu_torch.ops.kernels import build, fps
    from toothgroupnetwork_tpu_torch.ops.kernels._launch import stream_of

    smi = chip_smoke.smi_line()
    dev = torch.device("cuda", 0)
    lib = build.library()
    gen = torch.Generator().manual_seed(0)
    for b, n, m, n_valid in SHAPES:
        xyz = torch.randn((b, n, 3), generator=gen).to(dev)
        valid = None
        if n_valid is not None:
            valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
            valid[:, :n_valid] = True
        dist = torch.empty((b, n), device=dev)
        out = torch.empty((b, m), dtype=torch.int32, device=dev)
        ref = fps.fps(xyz, m, valid)
        times = {}
        for c in SIZES:
            def call():
                build.check(lib.tgn_fps(xyz.data_ptr(),
                                        None if valid is None else valid.data_ptr(),
                                        b, n, m, c, dist.data_ptr(), out.data_ptr(),
                                        stream_of(dev)), "tgn_fps")
            times[c] = chip_smoke.cuda_ms(call, 2)
            if not torch.equal(out, ref):
                raise AssertionError(f"[{b},{n}]->{m}: cluster {c} differs")
        print(json.dumps({"shape": f"[{b},{n}]->{m}", "valid": n_valid,
                          "ms_by_cluster": times, "picked": fps.cluster_size(n),
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
