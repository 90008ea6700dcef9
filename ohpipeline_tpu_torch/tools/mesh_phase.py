"""Phase 19 of ``chip_smoke.py`` alone: the multi-device layer on every
visible card (``make_mesh()``) and on the logical mesh of four entries on
``cuda:0``, each against ``mesh=None``, over the smoke test's content, and
each kernel of the mesh path against its plain version at the logical
mesh's block shapes.  On a machine with several cards the first mesh spans
them, so its serving blocks and its room fan-out copy between cards.

    python -m ohpipeline_tpu_torch.tools.mesh_phase
"""

from __future__ import annotations

import subprocess
import time

from . import smoke


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_phase: no CUDA device")
    cs = smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    _jobs, encoded = cs.flac_content()
    content = cs.codec_content()
    print(f"mesh_phase: content built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs = cs.mesh_phase([b for _, b in encoded], [t for t, _ in encoded],
                         cs.aac_streams(), cs.he_streams(), content["mp3"])
    print(f"mesh_phase: {torch.cuda.device_count()} card(s), phase 19 in "
          f"{time.perf_counter() - t0:.1f} s; kernels against their plain "
          f"versions at the mesh's block shapes, max |err| {errs}")


if __name__ == "__main__":
    main()
