"""A loopback web site of French pages, for the corpus build.

    pages = render_pages(chunks, n_pages)
    with FakeSite(pages) as site:
        Scraper(paths.raw, ScraperConfig(scope_prefix=site.scope,
                                         delay_s=0.0)).crawl([site.root])

serves `pages` ({path: html}) with nothing leaving the machine: a stdlib
`ThreadingHTTPServer` on 127.0.0.1, a free port, in a daemon thread, for the
scraper's own `default_fetch`. Every page carries a `Last-Modified` date; a
request whose `If-Modified-Since` is that date gets 304, as a conditional
GET does, and `set_page` gives a page new text and a later date. `counts`
tallies the answers by status.

`render_pages` writes chunk dicts as CNIL-style pages in the layout of
`tests/test_ingest_e2e.py`: a `region-content` block with one `<h2>` and
one `<p>` per chunk, each heading numbered within its page so the chunker
keeps every section a chunk of its own, plus a site map at
`/fr/plan-du-site` that links to every page (the crawl's root; the relevance
filter drops it by its URL, as it drops cnil.fr's own).
"""

from __future__ import annotations

import html
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

FIRST_DATE = "Mon, 01 Jun 2026 08:00:00 GMT"
SITE_MAP = "/fr/plan-du-site"


def page_path(p: int) -> str:
    return f"/fr/doc/{p}"


def render_page(title: str, sections: list[tuple[str, str]]) -> str:
    """One page: `title` and its (heading, text) sections."""
    body = "\n".join(
        f"<h2>{html.escape(h)}</h2>\n<p>{html.escape(t)}</p>"
        for h, t in sections)
    return (f'<html><head><meta charset="utf-8"><title>{html.escape(title)}'
            f'</title></head><body><div class="region-content">\n{body}\n'
            f"</div></body></html>")


def page_sections(chunks: list[dict]) -> list[tuple[str, str]]:
    return [(f"{c.get('heading') or c.get('title', '')} ({j + 1})",
             c["text"]) for j, c in enumerate(chunks)]


def render_pages(chunks: list[dict], n_pages: int) -> dict[str, str]:
    """Chunk i goes to page i % n_pages, in order; then the site map."""
    groups: list[list[dict]] = [[] for _ in range(n_pages)]
    for i, c in enumerate(chunks):
        groups[i % n_pages].append(c)
    pages = {page_path(p): render_page(g[0].get("title", ""),
                                       page_sections(g))
             for p, g in enumerate(groups) if g}
    links = "\n".join(f'<li><a href="{path}">{path}</a></li>'
                      for path in pages)
    pages[SITE_MAP] = (
        "<html><head><title>Plan du site</title></head><body>"
        f'<div class="region-content"><ul>\n{links}\n</ul></div>'
        "</body></html>")
    return pages


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256


class FakeSite:
    def __init__(self, pages: dict[str, str]):
        self.pages = {path: (text.encode("utf-8"), FIRST_DATE)
                      for path, text in pages.items()}
        self.counts: dict[int, int] = {}
        self.url = ""
        self._lock = threading.Lock()
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None

    @property
    def root(self) -> str:
        return self.url + SITE_MAP

    @property
    def scope(self) -> str:
        return self.url + "/fr/"

    def set_page(self, path: str, text: str, last_modified: str) -> None:
        with self._lock:
            self.pages[path] = (text.encode("utf-8"), last_modified)

    def __enter__(self) -> "FakeSite":
        self._server = _Server(("127.0.0.1", 0), self._handler())
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fake-site", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()

    def _answer(self, path: str, since: str):
        """(status, body, date) of one GET."""
        with self._lock:
            page = self.pages.get(path)
        if page is None:
            status, body, date = 404, b"", ""
        elif since and since == page[1]:
            status, body, date = 304, b"", page[1]
        else:
            status, (body, date) = 200, page
        with self._lock:
            self.counts[status] = self.counts.get(status, 0) + 1
        return status, body, date

    def _handler(self):
        site = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                status, body, date = site._answer(
                    self.path, self.headers.get("If-Modified-Since", ""))
                self.send_response(status)
                if date:
                    self.send_header("Last-Modified", date)
                if status == 200:
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler
