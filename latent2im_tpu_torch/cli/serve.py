"""Serving CLI: HTTP edit/sweep endpoints over a warm Editor — PyTorch port
of latent2im_tpu/cli/serve.py.

- **Fixed width.** Every request pads to ``--serve_batch`` rows and the
  answer is sliced back ON THE DEVICE before the host copy, so only the real
  rows cross to the host. (PyTorch compiles nothing per shape; the fixed
  width keeps the device work per request, and what the micro-batcher packs,
  the same as in the JAX server.)
- **One device queue.** A lock serializes device work while the stdlib
  ThreadingHTTPServer overlaps request parsing and PNG encoding with it.
- **PNG** is encoded with the standard library alone (zlib + struct).
- **Over a mesh.** --n_devices / --sp_devices run N x S ranks (the
  inference mesh of parallel/spatial.py, launched here or joined under
  torchrun). Rank 0 serves HTTP; for each request it broadcasts the call and
  its padded batch to the other ranks, which make the same call (the batch
  shards over the data axis, G's rows over the spatial one) until
  the server closes.

Endpoints (JSON in, JSON out; images as base64 PNG):
  GET  /healthz          -> {"status": "ok", ...}
  POST /edit   {"z": [[...]] | "seed": int, "alpha": float | [floats],
                "index": optional regressor-table attr id}
               -> {"images": [b64 png], "alpha_org": [[...]]}
  POST /sweep  {"z" | "seed", "num_panels": P, "min_alpha", "max_alpha"}
               -> {"panels": [[b64 png] * P], "alpha_org": [[...]]}

Usage (a trained walk from --save_path_w, a random one without it):
  python -m latent2im_tpu_torch.cli.serve <run_dir>/opt.yml --port 8642 \
      --save_path_w <run_dir>/model_w_10_final_walk_module.ckpt [--serve_batch 4]
"""

from __future__ import annotations

import base64
import json
import threading
import time

import numpy as np

from ..config.options import VisOptions
from ..device import resolve_device
from ..engine.build import load_editor_for_inference
from ..parallel import launch as launchlib
from ..parallel import mesh as meshlib
from ..parallel.spatial import setup_inference_mesh
from ..tasks.transforms import get_task, task_kwargs_from_options
from ..utils.image import png_bytes

HEARTBEAT_S = 60.0  # rank 0 of a mesh wakes the idle ranks this often


def _png_b64(img_u8: np.ndarray) -> str:
    return base64.b64encode(png_bytes(img_u8)).decode("ascii")


class MicroBatcher:
    """Cross-request micro-batching for single-sample edits: single-sample
    /edit requests enqueue here; a worker waits ``window_ms`` for company,
    packs up to serve_batch rows into ONE ``_edit_batch`` call and hands each
    requester its own row back."""

    def __init__(self, service: "EditService", window_ms: float = 8.0):
        self.svc = service
        self.window_s = window_ms / 1000.0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[dict] = []
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def edit_one(self, z_row: np.ndarray, alpha: float):
        if not self._worker.is_alive():
            raise RuntimeError(
                "micro-batch worker died; restart the server or disable "
                "--batch_window_ms"
            )
        box = {"z": z_row, "alpha": alpha, "done": threading.Event()}
        with self._lock:
            self._pending.append(box)
            self._cond.notify()
        if not box["done"].wait(timeout=300):
            raise RuntimeError("micro-batch worker timed out")
        if "err" in box:
            raise box["err"]
        if "img" not in box:  # worker died mid-batch on a BaseException
            raise RuntimeError("micro-batch worker aborted")
        return box["img"], box["alpha_org"]

    def _loop(self):
        while True:
            with self._lock:
                while not self._pending:
                    self._cond.wait()
                # wait for company, but launch early once a full width queues
                deadline = time.monotonic() + self.window_s
                while len(self._pending) < self.svc.batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = self._pending[: self.svc.batch]
                del self._pending[: len(batch)]
            try:
                z = np.stack([b["z"] for b in batch]).astype(np.float32)
                a = np.asarray([b["alpha"] for b in batch], np.float32)
                imgs, alpha_org = self.svc._edit_batch(z, a)
                for i, b in enumerate(batch):
                    b["img"], b["alpha_org"] = imgs[i], alpha_org[i]
            except BaseException as e:  # noqa: BLE001 — waiters must never
                # block on a dead worker; give every box the error, then
                # re-raise non-Exception signals
                err = e if isinstance(e, Exception) else RuntimeError(
                    f"micro-batch worker aborted: {type(e).__name__}: {e}"
                )
                for b in batch:
                    b["err"] = err
                if not isinstance(e, Exception):
                    for b in batch:
                        b["done"].set()
                    raise
            finally:
                for b in batch:
                    b["done"].set()


class _Broadcasting:
    """Rank 0's editor over a mesh: each program call goes first to the
    other ranks (``follow``), which make the same call."""

    def __init__(self, editor, mesh):
        self.editor, self.mesh = editor, mesh

    def __getattr__(self, name):
        return getattr(self.editor, name)

    def _call(self, name, walk_params, args, kwargs):
        meshlib.broadcast_object(self.mesh, (name, args, kwargs))
        return getattr(self.editor, name)(walk_params, *args, **kwargs)

    def apply_alpha(self, walk_params, *args, **kwargs):
        return self._call("apply_alpha", walk_params, args, kwargs)

    def sweep(self, walk_params, *args, **kwargs):
        return self._call("sweep", walk_params, args, kwargs)

    def heartbeat(self) -> None:
        """A call the other ranks skip: it ends their wait in a collective
        before the group's timeout does."""
        meshlib.broadcast_object(self.mesh, "heartbeat")

    def stop(self) -> None:
        meshlib.broadcast_object(self.mesh, None)


class EditService:
    """Fixed-width edit/sweep over one Editor, on one device or (mesh) as
    rank 0 of a mesh whose other ranks ``follow``."""

    def __init__(self, editor, walk_params, task, batch: int,
                 num_panels: int, min_alpha: float, max_alpha: float, mesh=None):
        self.mesh = mesh
        self._closed = threading.Event()
        if mesh is not None and mesh.is_main:
            editor = _Broadcasting(editor, mesh)
            threading.Thread(target=self._heartbeats, daemon=True).start()
        self.ed = editor
        self.walk = walk_params
        self.task = task
        self.batch = batch
        self.num_panels = num_panels
        self.min_alpha, self.max_alpha = min_alpha, max_alpha
        self.dim_z = editor.cfg.dim_z
        self._dev_lock = threading.Lock()  # one device queue
        self.device_calls = 0  # observability: edit/sweep device calls
        self.batcher: MicroBatcher | None = None

    def enable_batching(self, window_ms: float = 8.0) -> None:
        self.batcher = MicroBatcher(self, window_ms=window_ms)

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh (or one process): the rank that serves."""
        return self.mesh is None or self.mesh.is_main

    def follow(self) -> None:
        """A rank other than 0: make each call rank 0 broadcasts, until it
        closes."""
        while (msg := meshlib.broadcast_object(self.mesh)) is not None:
            if msg == "heartbeat":
                continue
            name, args, kwargs = msg
            getattr(self.ed, name)(self.walk, *args, **kwargs)

    def _heartbeats(self) -> None:
        """Rank 0 of a mesh: while no request comes, the other ranks wait in
        ``follow``'s broadcast; wake them every HEARTBEAT_S, well inside
        the collective timeout."""
        while not self._closed.wait(HEARTBEAT_S):
            with self._dev_lock:
                if not self._closed.is_set():
                    self.ed.heartbeat()

    def close(self) -> None:
        """Rank 0 of a mesh: release the other ranks from ``follow``."""
        if self.mesh is not None and self.mesh.is_main:
            with self._dev_lock:
                self._closed.set()
                self.ed.stop()

    def _pad(self, z: np.ndarray) -> tuple[np.ndarray, int]:
        n = z.shape[0]
        if n > self.batch:
            raise ValueError(
                f"request batch {n} exceeds --serve_batch {self.batch}"
            )
        if n < self.batch:
            z = np.concatenate([z, np.repeat(z[-1:], self.batch - n, axis=0)])
        return z, n

    def _zs(self, req: dict) -> np.ndarray:
        if "z" in req:
            z = np.asarray(req["z"], np.float32)
            if z.ndim == 1:
                z = z[None]
            if z.ndim != 2 or z.shape[-1] != self.dim_z:
                raise ValueError(
                    f"z must have dim {self.dim_z}, got shape {z.shape}"
                )
            if not 1 <= z.shape[0] <= self.batch:
                raise ValueError(
                    f"request batch must be 1..{self.batch} (serve_batch), "
                    f"got {z.shape[0]}"
                )
            return z
        seed = int(req.get("seed", 0))
        n = int(req.get("num_samples", 1))
        # validate before allocating
        if not 1 <= n <= self.batch:
            raise ValueError(
                f"num_samples must be 1..{self.batch} (serve_batch), got {n}"
            )
        return np.random.RandomState(seed).randn(n, self.dim_z).astype(
            np.float32
        )

    def warmup(self) -> None:
        """One full-width edit and sweep before the listener opens (cuDNN
        picks its algorithms and the kernel library loads on first use)."""
        z = np.zeros((self.batch, self.dim_z), np.float32)
        self.edit({"z": z.tolist(), "alpha": 0.5})
        self.sweep({"z": z.tolist()})

    def _edit_batch(self, z: np.ndarray, a: np.ndarray, index=None):
        """Raw fixed-width edit: z [n, D], a [n] -> (uint8 imgs [n, ...],
        alpha_org [n, ...]). Every edit route funnels through here; the [:n]
        slice runs on the device, before the host copy."""
        zp, n = self._pad(z)
        ap = np.concatenate(
            [a, np.repeat(a[-1:], zp.shape[0] - n, axis=0)]
        )[:, None]
        with self._dev_lock:
            self.device_calls += 1
            edited, alpha_org, _ = self.ed.apply_alpha(
                self.walk, zp, ap,
                index=None if index is None else int(index), u8=True,
            )
            return edited[:n].cpu().numpy(), alpha_org[:n].cpu().numpy()

    def edit(self, req: dict) -> dict:
        z = self._zs(req)
        a = np.asarray(req.get("alpha", 1.0), np.float32).reshape(-1)
        if a.shape[0] == 1:
            a = np.repeat(a, z.shape[0])
        if a.shape[0] != z.shape[0]:
            raise ValueError("alpha length must be 1 or match the z batch")
        index = req.get("index")
        if self.batcher is not None and z.shape[0] == 1 and index is None:
            img, alpha_org = self.batcher.edit_one(z[0], float(a[0]))
            return {"images": [_png_b64(img)],
                    "alpha_org": [alpha_org.tolist()]}
        imgs, alpha_org = self._edit_batch(z, a, index)
        return {
            "images": [_png_b64(im) for im in imgs],
            "alpha_org": alpha_org.tolist(),
        }

    def sweep(self, req: dict) -> dict:
        z = self._zs(req)
        # a panel count other than the configured one changes the device
        # work per request; a client opts in explicitly, as in the JAX server
        p = int(req.get("num_panels", self.num_panels))
        if p != self.num_panels and not bool(req.get("allow_compile")):
            raise ValueError(
                f"num_panels={p} differs from the configured "
                f"{self.num_panels}; pass \"allow_compile\": true to accept it"
            )
        if not 1 <= p <= 64:
            raise ValueError(f"num_panels must be 1..64, got {p}")
        lo = float(req.get("min_alpha", self.min_alpha))
        hi = float(req.get("max_alpha", self.max_alpha))
        zp, n = self._pad(z)
        alphas = np.linspace(lo, hi, p)
        panels = np.stack(
            [self.task.scale_test_alpha(a_, zp.shape[0]) for a_ in alphas]
        ).astype(np.float32)
        with self._dev_lock:
            self.device_calls += 1
            imgs, alpha_org, _ = self.ed.sweep(self.walk, zp, panels, u8=True)
            imgs = imgs[:, :n].cpu().numpy()  # [P, n, H, W, 3] uint8
            alpha_org = alpha_org[:n].cpu().numpy()
        return {
            "panels": [[_png_b64(imgs[pi, bi]) for bi in range(n)]
                       for pi in range(p)],
            "alphas": alphas.tolist(),
            "alpha_org": alpha_org.tolist(),
        }


def make_server(service: EditService, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — stdlib API
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "serve_batch": service.batch,
                    "attr_list": list(service.ed.cfg.attr_list),
                    "size": service.ed.cfg.size,
                    "device": str(service.ed.device),
                    "device_calls": service.device_calls,
                    "micro_batching": service.batcher is not None,
                })
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802 — stdlib API
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/edit":
                    self._reply(200, service.edit(req))
                elif self.path == "/sweep":
                    self._reply(200, service.sweep(req))
                else:
                    self._reply(404, {"error": "unknown path"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving boundary
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return ThreadingHTTPServer((host, port), Handler)


def build_service(opt, conf, device=None) -> EditService:
    """Editor + walk + task behind an EditService on ``device`` (cuda unless
    the caller asks for the CPU). Under --n_devices / --sp_devices the
    process is one rank of the mesh (launched by ``main`` or torchrun): rank
    0's service serves, the others ``follow``; the spatial context stays
    entered for the service's lifetime, as in the JAX package."""
    editor, walk_params, info = load_editor_for_inference(opt, conf, device)
    editor, walk_params, mesh, sp_ctx = setup_inference_mesh(opt, editor, walk_params)
    sp_ctx.__enter__()
    task = get_task(conf.transform, walk_type=conf.walk_type,
                    nsliders=len(info["attr_list"]),
                    **task_kwargs_from_options(conf))
    return EditService(
        editor, walk_params, task,
        batch=getattr(opt, "serve_batch", None) or 4,
        num_panels=opt.num_panels,
        min_alpha=opt.min_alpha, max_alpha=opt.max_alpha, mesh=mesh,
    )


def serve(opt, conf, device=None) -> None:
    """One rank's part: rank 0 warms the path and serves HTTP until it is
    stopped, then releases the others, which follow it meanwhile."""
    service = build_service(opt, conf, device)
    if not service.is_main:
        service.follow()
        return
    try:
        print("warming the edit/sweep path ...", flush=True)
        service.warmup()
        if opt.batch_window_ms > 0:
            service.enable_batching(opt.batch_window_ms)
        srv = make_server(service, opt.host, opt.port)
        print(f"serving on http://{opt.host}:{opt.port} "
              f"(batch {service.batch}, {service.ed.cfg.size}px, "
              f"{service.ed.device})", flush=True)
        srv.serve_forever()
    finally:
        service.close()


def main(argv=None):
    vo = VisOptions()
    vo.parser.add_argument("--port", type=int, default=8642)
    vo.parser.add_argument("--host", type=str, default="127.0.0.1")
    vo.parser.add_argument("--serve_batch", type=int, default=4,
                           help="fixed request width; requests pad up and "
                                "slice back")
    vo.parser.add_argument("--batch_window_ms", type=float, default=8.0,
                           help="micro-batching window: concurrent "
                                "single-sample /edit requests coalesce into "
                                "one device call (0 disables)")
    opt, conf = vo.parse(argv)
    device = resolve_device(None)
    n = (getattr(opt, "n_devices", None) or 1) * (getattr(opt, "sp_devices", None) or 1)
    if n > 1 and not launchlib.is_rank(n, device):
        launchlib.launch(serve, (opt, conf, device), world_size=n, device=device)
        return
    serve(opt, conf, device)


if __name__ == "__main__":
    main()
