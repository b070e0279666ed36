"""A gloo world of CPU ranks for the port's multi-rank tests.

``with World(job, size, inputs, work) as ranks:`` starts ``size`` Python
processes, each of which joins a gloo process group through the port's own
``parallel.initialize_multihost`` (a TCP store on 127.0.0.1, a 30 s
collective timeout), runs ``job(rank, size, inputs, work)`` and pickles what
it returns to ``work/rank{r}.pkl``. A child sets PyTorch to one thread and
makes ``jax``, ``optax``, ``yaml`` and the JAX package unimportable before
it imports anything, so a job also shows that the port's multi-rank paths
need none of them; ``job`` is "module:function" in a module that imports no
JAX (``tests/torch_parallel_jobs.py``).

``join(deadline)`` waits for every rank until ``deadline`` seconds after the
start, kills every rank still running when it expires, and fails with the
ranks' standard error: a collective that hangs fails its test, it does not
hang the suite. Leaving the block kills every rank still running, so a
failure in the parent between the start and the join leaves no rank
behind. ``world_of_one`` opens a group of the calling process alone, for the
checks a one-rank mesh allows in process.
"""
import contextlib
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, {root!r})
    import datetime, importlib, os, pickle
    import torch
    torch.set_num_threads(1)
    from vqvae_speech_tpu_torch.parallel.mesh import (
        initialize_multihost, shutdown)
    rank, size, port = (int(a) for a in sys.argv[1:4])
    job, work = sys.argv[4], sys.argv[5]
    initialize_multihost(f"127.0.0.1:{{port}}", size, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=30))
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    module, fn = job.split(":")
    out = getattr(importlib.import_module(module), fn)(rank, size, inputs,
                                                       work)
    with open(os.path.join(work, f"rank{{rank}}.pkl"), "wb") as f:
        pickle.dump(out, f)
    shutdown()
""").format(root=REPO_ROOT)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, job: str, size: int, inputs, work: str):
        self.job, self.size, self.work = job, size, str(work)
        os.makedirs(self.work, exist_ok=True)
        with open(os.path.join(self.work, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        self.procs = []

    def __enter__(self) -> "World":
        port = free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.t0 = time.monotonic()
        for rank in range(self.size):
            err = open(os.path.join(self.work, f"rank{rank}.err"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, str(rank), str(self.size),
                 str(port), self.job, self.work],
                cwd=self.work, env=env, stdout=err, stderr=subprocess.STDOUT))
            err.close()
        return self

    def __exit__(self, *exc):
        self._kill()

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _errors(self) -> str:
        out = []
        for rank in range(self.size):
            with open(os.path.join(self.work, f"rank{rank}.err")) as f:
                out.append(f"--- rank {rank} ---\n" + f.read()[-4000:])
        return "\n".join(out)

    def join(self, deadline: float):
        """Every rank's returned value, in rank order."""
        while any(p.poll() is None for p in self.procs):
            failed = any(p.returncode not in (None, 0) for p in self.procs)
            if failed or time.monotonic() - self.t0 > deadline:
                self._kill()
                why = ("a rank failed" if failed else
                       f"the world outlived its {deadline} s deadline")
                raise AssertionError(f"{why}:\n{self._errors()}")
            time.sleep(0.05)
        if any(p.returncode for p in self.procs):
            raise AssertionError(f"a rank failed:\n{self._errors()}")
        outs = []
        for rank in range(self.size):
            with open(os.path.join(self.work, f"rank{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of this process alone, and its (1, 1) mesh; the
    group is destroyed on the way out."""
    import torch.distributed as dist

    from vqvae_speech_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
        shutdown,
    )

    assert not dist.is_initialized(), "a process group is open already"
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        shutdown()
