"""Test set-up shared by every test directory of the repository.

Under xdist, each worker builds the JAX package's native helpers before it
collects a test module.  ``ohpipeline_tpu.native._load`` runs ``g++ -o``
straight onto the shared ``.so`` path, and some of the JAX package's test
modules load a helper as they are imported (their ``skipif`` marks), so
workers collecting side by side could dlopen a library another was still
writing and find it "unavailable" for the rest of the run.  Here each
worker takes an exclusive lock in the package's ``_build/`` and calls
every ``_*_lib`` loader under it: the first builds, the others then find
whole, up-to-date libraries and only load them.  A run in one process has
no race and builds each helper at its first use.
"""

import fcntl
import os

JAX_NATIVE_LIBS = ("flac", "aac", "sbr", "mp3", "celt", "vorbis", "silk",
                   "alac")


def pytest_configure(config):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    from ohpipeline_tpu import native

    native._BUILD.mkdir(parents=True, exist_ok=True)
    with open(native._BUILD / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released as it closes
        for name in JAX_NATIVE_LIBS:
            getattr(native, f"_{name}_lib")()
