"""rpc_view -- view another server's console pages (a copy of
``brpc_tpu/tools/rpc_view.py``): a fetch-and-print CLI, or a local
proxy port onto the remote console.

Examples:
  python -m brpc_tpu_torch.tools.rpc_view --target 127.0.0.1:8000 --path /status
  python -m brpc_tpu_torch.tools.rpc_view --target 127.0.0.1:8000 --serve 8888
"""
from __future__ import annotations

import argparse
import sys
import urllib.request


def fetch(target: str, path: str = "/index", timeout: float = 5.0) -> str:
    if not path.startswith("/"):
        path = "/" + path
    with urllib.request.urlopen(f"http://{target}{path}",
                                timeout=timeout) as r:
        return r.read().decode(errors="replace")


def serve_proxy(target: str, port: int) -> None:
    """Local proxy: browse http://127.0.0.1:<port>/<any builtin path>."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            try:
                body = fetch(target, self.path).encode()
                self.send_response(200)
            except Exception as e:
                body = f"proxy error: {e}".encode()
                self.send_response(502)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"proxying {target} on http://127.0.0.1:{httpd.server_port}/",
          file=sys.stderr)
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--target", required=True, help="host:port of a server")
    ap.add_argument("--path", default="/index")
    ap.add_argument("--serve", type=int, default=0,
                    help="run a local proxy on this port instead")
    a = ap.parse_args(argv)
    if a.serve:
        serve_proxy(a.target, a.serve)
    else:
        print(fetch(a.target, a.path))


if __name__ == "__main__":
    main()
