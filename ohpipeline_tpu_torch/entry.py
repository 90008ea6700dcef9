"""Entry point of the port's flagship step (``__graft_entry__.entry`` of the
JAX package, on one device)."""

from __future__ import annotations

import torch

from . import parallel


def entry(device="cuda"):
    """-> (fn, args): the decode->render step and its example inputs as
    tensors on ``device`` (the card unless the caller asks for the CPU);
    ``fn(*args)`` returns (rendered, peaks)."""
    args = tuple(torch.from_numpy(a).to(device)
                 for a in parallel.example_step_args(nframes=8, n=1024))

    def fn(*a):
        return parallel.decode_render_step(*a, num_channels=2)

    return fn, args
