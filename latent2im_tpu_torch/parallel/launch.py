"""Start one process per rank and run a function on each.

JAX drives every chip from one process; torch.distributed wants one process
per rank. ``launch(fn, args, world_size=n)`` spawns n workers (the
``spawn`` start method: each imports afresh), joins them to one process
group through a ``FileStore`` in a temporary directory (no port to
contend for), pins each CUDA worker to card ``rank % device_count`` (or the
CPU for ``device="cpu"``), runs ``fn(*args)`` on every rank and returns
rank 0's result. The backend is ``mesh.choose_backend``'s: NCCL when every
rank has a card of its own, else gloo.

A rank that raises fails the run: its traceback comes back to the caller
in a RuntimeError, the other ranks are terminated (then killed) within
``grace`` seconds, and no rank carries on alone. ``timeout`` (None: no
limit, as the CLIs run) bounds the whole run; each collective waits at
most ``mesh.COLLECTIVE_TIMEOUT``, whatever the run's length. SIGTERM to the launching process is passed on to the workers,
whose CLIs checkpoint and stop together (``mesh.any_rank``).

The CLIs call it themselves when --n_devices x --sp_devices > 1 and no
RANK is in the environment (under torchrun, each process joins through
``mesh.init_distributed`` instead).
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import COLLECTIVE_TIMEOUT, choose_backend, init_distributed


def _worker(rank, world, store_path, backend, device_type, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        out = fn(*args)
        if rank == 0:
            results.put(("result", pickle.dumps(out)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)


_NONE = object()


def launch(fn, args=(), *, world_size: int, device="cuda", timeout: float | None = None,
           grace: float = 20.0):
    """Run ``fn(*args)`` on ``world_size`` spawned ranks -> rank 0's return
    value (pickled back: move tensors to the CPU first). ``fn`` must be
    importable by name (a module-level function)."""
    device_type = torch.device(device).type
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and count == 0:
        raise RuntimeError("launch: no CUDA device; pass device='cpu' for the CPU")
    backend = choose_backend(device_type, world_size, count)
    logging.getLogger(__name__).info("launching %d ranks on %s, backend %s", world_size,
                                     device_type, backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="l2i_rdzv_")
    procs = [ctx.Process(target=_worker, daemon=False,
                         args=(r, world_size, os.path.join(tmp, "store"), backend,
                               device_type, fn, args, results))
             for r in range(world_size)]

    def forward_term(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    main = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, forward_term) if main else None
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        result, error = _NONE, None
        while error is None:
            try:
                msg = results.get(timeout=0.2)
            except queue.Empty:
                msg = None
            if msg is not None and msg[0] == "error":
                error = f"rank {msg[1]} failed:\n{msg[2]}"
            elif msg is not None:
                result = pickle.loads(msg[1])
            elif all(p.exitcode is not None for p in procs):
                break
            else:
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    error = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"the {world_size} ranks did not finish within {timeout:.0f} s"
        if error is None and any(p.exitcode != 0 for p in procs):
            error = f"exit codes {[p.exitcode for p in procs]}"
        if error is None and result is _NONE:
            error = "rank 0 returned no result"
        if error is not None:
            raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, "
                               f"{world_size} ranks, {backend}): {error}")
        return result
    finally:
        if main:
            signal.signal(signal.SIGTERM, prev)
        _stop(procs, grace)
        shutil.rmtree(tmp, ignore_errors=True)


def _stop(procs, grace: float) -> None:
    """Terminate, then kill, every worker still running; join them all."""
    procs = [p for p in procs if p.pid is not None]  # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    end = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)


def is_rank(world_size: int, device) -> bool:
    """True when this process is one of ``world_size`` ranks: it already
    is, or torchrun's environment (RANK, WORLD_SIZE) makes it one, joined
    here. False: the caller launches the ranks (``launch``)."""
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_distributed(device_type=torch.device(device).type)
    if not dist.is_initialized():
        return False
    if dist.get_world_size() != world_size:
        raise ValueError(f"this process group has {dist.get_world_size()} ranks; "
                         f"the flags ask for {world_size}")
    return True
