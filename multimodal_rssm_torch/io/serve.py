"""Model server: HTTP inference over exported ``torch.export`` artifacts.

Port of the JAX package's ``io/serve.py``.  ``cli/export_model.py``
freezes a trained run into ``*.pt2`` artifacts (``io/export.py``: weights
baked in, no model code needed), and this module serves them over HTTP so
a robot controller or logger can call the posterior filter / decoder /
agent step / planner from any language.  It imports torch, NumPy and the
standard library only: where it runs, no model code of the port is
imported.

- **Stateless**: the recurrent (belief, state) carry travels with the
  client, as the artifacts' calling convention has it, so the server
  scales horizontally and a controller can fail over mid-episode.
- **Binary npz protocol**: request body = ``.npz`` of named input arrays,
  response = ``.npz`` of named outputs.  Nested structures flatten to
  dotted keys (``obs.image_horizon``, ``expert_means.sound``).  The key is
  ``uint32[2]`` on the wire (the JAX package's key data) and is widened to
  int64 before the call.
- **Threaded** stdlib ``http.server``, one call at a time per artifact.

Endpoints:

    GET  /healthz            -> {"status": "ok"}
    GET  /v1/info            -> artifact names, device, compute dtype,
                                argument names, input / output signatures
    POST /v1/call/<artifact> -> npz in, npz out

A request missing an input, or with an input of another shape or dtype
than the artifact was exported for, and an unknown artifact, are answered
400; an unknown path 404; a failure in the call 500 with the exception's
name.

Client sketch::

    buf = io.BytesIO(); np.savez(buf, h=h, s=s, action=a,
                                 **{"obs." + k: v for k, v in obs.items()},
                                 nonterminal=nt, key=key_data)
    r = urllib.request.urlopen(url + "/v1/call/filter_step", buf.getvalue())
    out = dict(np.load(io.BytesIO(r.read())))
"""

from __future__ import annotations

import io
import json
import os
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "."
SUFFIX = ".pt2"
META_NAME = "mrssm_artifact.json"   # the artifact's description, in the .pt2


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Tree of arrays -> flat {dotted key: array} dict (dict / list / tuple
    containers; leaves are array-likes, tensors included)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}{SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1] if prefix else "value"] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """Inverse of :func:`flatten_tree` (dict nodes only: positional
    artifact arguments are reassembled by the caller from known names)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def read_meta(path: str) -> Dict[str, Any]:
    """The description ``io/export.py`` stores in a ``.pt2``: its kind,
    device, compute dtype, argument names and flat input / output
    signatures ({dotted key: [dtype, shape]})."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"/extra/{META_NAME}")]
        if not names:
            raise ValueError(f"{path}: not an artifact of io/export.py (no "
                             f"{META_NAME} inside)")
        return json.loads(z.read(names[0]))


def load_exported(path: str, device: Optional[str] = None):
    """(callable, description) of an artifact: ``torch.export.load(path)
    .module()`` and :func:`read_meta`.  Raises ``RuntimeError``, naming the
    device, when the artifact was exported for a device that is not
    visible here, or ``ValueError`` when ``device`` is given and differs
    from the artifact's."""
    meta = read_meta(path)
    where = meta["device"]
    if device is not None and torch.device(device).type != where:
        raise ValueError(f"{path}: exported for {where}, asked to run on "
                         f"{device}")
    if where == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: exported for cuda, and no CUDA device "
                           "is visible here")
    return torch.export.load(path).module(), meta


def _check_input(name: str, value: np.ndarray, spec) -> Optional[str]:
    dtype, shape = spec
    if name == "key" and value.dtype in (np.uint32, np.int64):
        value = value.astype(np.int64)
    if str(value.dtype) != dtype or list(value.shape) != list(shape):
        return (f"{name}: {value.dtype}{list(value.shape)}, expected "
                f"{dtype}{list(shape)}")
    return None


class ArtifactStore:
    """Loads every ``*.pt2`` in a directory and dispatches calls.

    Each artifact's positional calling convention comes from its stored
    description: a flat request dict is split into the positional
    arguments by name (``h``, ``s``, ``action``, ``obs.*``,
    ``nonterminal``, ``key`` for the steps; ``h``, ``s`` for decode), so
    the server needs no model- or config-specific code.  ``device``, where
    given, must be every artifact's device.
    """

    def __init__(self, artifact_dir: str, device: Optional[str] = None):
        self.artifacts, self.meta = {}, {}
        for name in sorted(os.listdir(artifact_dir)):
            if name.endswith(SUFFIX):
                fn, meta = load_exported(os.path.join(artifact_dir, name),
                                         device)
                self.artifacts[name[: -len(SUFFIX)]] = fn
                self.meta[name[: -len(SUFFIX)]] = meta
        if not self.artifacts:
            raise FileNotFoundError(
                f"no *{SUFFIX} artifacts in {artifact_dir}; run "
                "python -m multimodal_rssm_torch.cli.export_model first")
        self._locks = {n: threading.Lock() for n in self.artifacts}

    def info(self) -> Dict[str, Any]:
        out = {}
        for name, meta in self.meta.items():
            out[name] = {
                "platforms": [meta["device"]],
                "device": meta["device"],
                "compute_dtype": meta["compute_dtype"],
                "arg_names": list(meta["arg_names"]),
                "in_avals": [f"{k}: {d}{list(s)}"
                             for k, (d, s) in meta["inputs"].items()],
                "out_avals": [f"{k}: {d}{list(s)}"
                              for k, (d, s) in meta["outputs"].items()],
            }
        return out

    def args(self, name: str, flat_inputs: Dict[str, np.ndarray]):
        """The positional arguments of artifact ``name`` (tensors on its
        device) from a flat request; ``ValueError`` on a missing input or
        a wrong shape or dtype."""
        meta = self.meta[name]
        flat = {k: np.asarray(v) for k, v in flat_inputs.items()}
        missing = [k for k in meta["inputs"] if k not in flat]
        if missing:
            raise ValueError(
                f"{name}: missing inputs {missing}; got {sorted(flat)}")
        bad = [m for k, spec in meta["inputs"].items()
               if (m := _check_input(k, flat[k], spec))]
        if bad:
            raise ValueError(f"{name}: {'; '.join(bad)}")
        dev = torch.device(meta["device"])

        def tensor(k):
            v = flat[k].astype(np.int64) if k == "key" else flat[k]
            return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

        # dict arguments (obs) keep the order they were exported with
        tree = unflatten_tree({k: tensor(k) for k in meta["inputs"]})
        return [tree[a] for a in meta["arg_names"]]

    def call(self, name: str, flat_inputs: Dict[str, np.ndarray]
             ) -> Dict[str, np.ndarray]:
        if name not in self.artifacts:
            raise KeyError(
                f"unknown artifact {name!r}; have {sorted(self.artifacts)}")
        args = self.args(name, flat_inputs)
        # one call at a time per artifact: keeps device memory bounded
        # under client bursts
        with self._locks[name], torch.no_grad():
            result = self.artifacts[name](*args)
        return flatten_tree(result)


class _Handler(BaseHTTPRequestHandler):
    store: ArtifactStore  # set by make_server
    quiet = True

    def log_message(self, fmt, *args):  # stdlib default logs every request
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"})
        elif self.path == "/v1/info":
            self._send_json(200, self.store.info())
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        prefix = "/v1/call/"
        if not self.path.startswith(prefix):
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        name = self.path[len(prefix):]
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = self.rfile.read(length)
            with np.load(io.BytesIO(payload)) as z:
                flat = {k: z[k] for k in z.files}
            out = self.store.call(name, flat)
            buf = io.BytesIO()
            np.savez(buf, **out)
            self._send(200, buf.getvalue(), "application/octet-stream")
        except (KeyError, ValueError) as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:  # surface the failure to the client
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 0,
                device: Optional[str] = None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``.server_address`` has the
    bound port (port=0 picks a free one)."""
    store = ArtifactStore(artifact_dir, device)
    handler = type("Handler", (_Handler,), {"store": store})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(artifact_dir: str, host: str = "127.0.0.1",
                  port: int = 8000, device: Optional[str] = None):
    httpd = make_server(artifact_dir, host, port, device)
    names = sorted(httpd.RequestHandlerClass.store.artifacts)
    print(f"serving artifacts {names} from {artifact_dir} "
          f"on http://{host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
