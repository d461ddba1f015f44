"""Serve an exported artifact over HTTP.

Port of ``mv3d_tpu/cli/serve.py``, with the same endpoints and formats:

    python -m mv3d_tpu_torch.cli.serve --artifact artifacts/mv3d --port 8472

  * ``GET  /healthz``  -> 200 JSON: the artifact's meta.
  * ``POST /predict``  -> the body is an ``.npz`` with ``points`` (M, 4)
    float32 and ``rgb`` (H, W, 3); the response is an ``.npz`` with
    ``boxes3d`` (K, 8, 3) and ``probs`` (K,), or JSON with
    ``Accept: application/json``. A batched request packs up to the
    artifact's batch size of frames as ``points_0/rgb_0 ..``; the response
    then carries ``boxes3d_i``/``probs_i`` per frame (JSON: a ``frames``
    list). A body that cannot be read gets 400 with the cause.

The model runs on ``--device`` (the card by default), and a short request
is padded to the artifact's batch with empty frames
(``ServingModel.predict_batch``). Where the JAX server serializes
executions with a lock on the thread that handles the request, this one
hands every execution to one long-lived model thread: PyTorch sets up
its per-thread CUDA state again on each new thread, and
``ThreadingHTTPServer`` makes a thread per request (on an H100 that cost
~140 ms per full-width request, ``chip_smoke.py``'s HTTP timing).
"""

from __future__ import annotations

import argparse
import io
import json
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class ModelServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that owns the model thread (``worker``) and
    stops it on ``server_close``."""

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self.worker = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="mv3d-model")

    def server_close(self):
        super().server_close()
        self.worker.shutdown()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="serve an exported MV3D "
                                             "artifact over HTTP")
    ap.add_argument("--artifact", required=True,
                    help="artifact dir written by cli/export")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8472)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    return ap.parse_args(argv)


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 0,
                device: str = "cuda") -> ModelServer:
    """Build (not start) the HTTP server; ``server_address[1]`` is the
    bound port (useful with port=0)."""
    from ..serving import load_serving

    model = load_serving(artifact_dir, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: no stderr access log
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, b'{"error": "not found"}',
                                   "application/json")
            self._reply(200, json.dumps(
                {"status": "ok", **model.meta}).encode(),
                "application/json")

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, b'{"error": "not found"}',
                                   "application/json")
            try:
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                frames = []
                with np.load(io.BytesIO(raw)) as z:
                    if "points" in z.files:        # single frame
                        frames = [(z["points"], z["rgb"])]
                        batched = False
                    else:                          # points_0/rgb_0, ...
                        batched = True
                        i = 0
                        while f"points_{i}" in z.files:
                            frames.append((z[f"points_{i}"], z[f"rgb_{i}"]))
                            i += 1
                        if not frames:
                            raise ValueError(
                                "npz needs points/rgb or points_i/rgb_i")
                # one model on one device: one execution at a time, all on
                # the model thread
                results = self.server.worker.submit(
                    model.predict_batch, frames).result()
            except Exception as e:  # noqa: BLE001 — the client gets the cause
                return self._reply(400, json.dumps(
                    {"error": repr(e)[:500]}).encode(), "application/json")
            if "application/json" in (self.headers.get("Accept") or ""):
                if batched:
                    body = json.dumps({"frames": [
                        {"boxes3d": b.tolist(), "probs": p.tolist()}
                        for b, p in results]}).encode()
                else:
                    b, p = results[0]
                    body = json.dumps({"boxes3d": b.tolist(),
                                       "probs": p.tolist()}).encode()
                return self._reply(200, body, "application/json")
            buf = io.BytesIO()
            if batched:
                np.savez_compressed(buf, **{
                    k: v for i, (b, p) in enumerate(results)
                    for k, v in ((f"boxes3d_{i}", b), (f"probs_{i}", p))})
            else:
                np.savez_compressed(buf, boxes3d=results[0][0],
                                    probs=results[0][1])
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return ModelServer((host, port), Handler)


def main(argv=None):
    args = parse_args(argv)
    srv = make_server(args.artifact, args.host, args.port, args.device)
    host, port = srv.server_address[:2]
    print(f"serving {args.artifact} on http://{host}:{port} "
          f"(POST /predict, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
