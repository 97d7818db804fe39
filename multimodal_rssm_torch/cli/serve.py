"""Serve exported model artifacts over HTTP (``io/serve.py``).

    python -m multimodal_rssm_torch.cli.serve --artifacts RUN_DIR/exported \\
        [--host 0.0.0.0] [--port 8000] [--device cuda|cpu]

Endpoints: GET /healthz, GET /v1/info, POST /v1/call/<artifact> (request
and response bodies are ``.npz`` archives of named arrays; nested
structures use dotted keys, e.g. ``obs.image_horizon``).  ``--device``
(default ``cuda``; without a GPU it raises) must be the device the
artifacts were exported on (``cli/export_model.py --device``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from multimodal_rssm_torch.cli import command


@command
def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--artifacts", required=True,
                        help="directory of *.pt2 files (cli/export_model.py "
                             "output)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.core.device import resolve_device
    from multimodal_rssm_torch.io.serve import serve_forever

    resolve_device(args.device)
    serve_forever(args.artifacts, args.host, args.port, args.device)


if __name__ == "__main__":
    main()
