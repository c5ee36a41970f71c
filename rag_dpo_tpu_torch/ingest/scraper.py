"""Polite resumable web scraper with incremental update support.

Role parity with `src/scraping/cnil_scraper_final.py`: BFS crawl bounded
by depth (≤5) and domain scope (:561-598), MIME-typed downloads (:53-69),
per-file metadata JSON with HTTP dates (:368-461), resumable state file
(:127-206) with a failed-URL list, and conditional-GET incremental updates
via If-Modified-Since / 304 (:638-786).

Design difference: fetching goes through an injectable `fetch` callable so
the crawler is hermetically testable (this build environment is
zero-egress) and so rate limiting / retry policy is pluggable.

Port: a copy of `rag_dpo_tpu/ingest/scraper.py` but for where the link
extractor's `BeautifulSoup` comes from (`ingest/htmltree.py`: bs4 and
lxml are not installed beside the CUDA stack).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import time
import urllib.parse
import urllib.request
from typing import Callable


@dataclasses.dataclass
class FetchResult:
    url: str
    status: int
    content: bytes = b""
    content_type: str = ""
    last_modified: str = ""
    etag: str = ""


def default_fetch(url: str, if_modified_since: str = "",
                  timeout: float = 30.0,
                  user_agent: str = "rag-dpo-tpu-crawler/1.0") -> FetchResult:
    headers = {"User-Agent": user_agent}
    if if_modified_since:
        headers["If-Modified-Since"] = if_modified_since
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return FetchResult(
                url=url, status=resp.status, content=resp.read(),
                content_type=resp.headers.get("Content-Type", ""),
                last_modified=resp.headers.get("Last-Modified", ""),
                etag=resp.headers.get("ETag", ""),
            )
    except urllib.error.HTTPError as e:
        return FetchResult(url=url, status=e.code)
    except Exception:
        return FetchResult(url=url, status=0)


_DOC_EXTENSIONS = {
    ".pdf": "pdf", ".docx": "docx", ".xlsx": "xlsx", ".ods": "ods",
    ".odt": "odt", ".png": "image", ".jpg": "image", ".jpeg": "image",
}


_FR_MONTHS = {
    "janvier": 1, "février": 2, "fevrier": 2, "mars": 3, "avril": 4,
    "mai": 5, "juin": 6, "juillet": 7, "août": 8, "aout": 8,
    "septembre": 9, "octobre": 10, "novembre": 11, "décembre": 12,
    "decembre": 12,
}


def extract_page_dates(html: bytes) -> dict:
    """Publication/update dates from stored HTML (no network): OpenGraph
    / article meta tags, <time datetime=…>, then French prose dates
    ('12 juillet 2024'). → {'published_at': iso_or_None, …}."""
    text = html.decode("utf-8", errors="replace")
    out: dict = {"published_at": None, "updated_at": None}
    for field, props in (
        ("published_at", ("article:published_time", "datePublished",
                          "date")),
        ("updated_at", ("article:modified_time", "dateModified")),
    ):
        for prop in props:
            m = re.search(
                rf'<meta[^>]+(?:property|name|itemprop)=["\']{prop}["\']'
                rf'[^>]+content=["\']([^"\']+)["\']', text, re.I)
            if m:
                out[field] = m.group(1)[:25]
                break
    if not out["published_at"]:
        m = re.search(r'<time[^>]+datetime=["\']([^"\']+)["\']', text,
                      re.I)
        if m:
            out["published_at"] = m.group(1)[:25]
    if not out["published_at"]:
        m = re.search(
            r"\b(\d{1,2})(?:er)?\s+(janvier|février|fevrier|mars|avril|"
            r"mai|juin|juillet|août|aout|septembre|octobre|novembre|"
            r"décembre|decembre)\s+(\d{4})\b", text, re.I)
        if m:
            day, month, year = (int(m.group(1)),
                                _FR_MONTHS[m.group(2).lower()],
                                int(m.group(3)))
            out["published_at"] = f"{year:04d}-{month:02d}-{day:02d}"
    return out


@dataclasses.dataclass
class ScraperConfig:
    scope_prefix: str = "https://www.cnil.fr/fr/"
    max_depth: int = 5
    delay_s: float = 0.5
    max_pages: int = 100_000


class Scraper:
    def __init__(self, out_dir, config: ScraperConfig | None = None,
                 fetch: Callable[..., FetchResult] | None = None):
        self.out = pathlib.Path(out_dir)
        self.config = config or ScraperConfig()
        self.fetch = fetch or default_fetch
        self.state_path = self.out / "_scraper_state.json"
        self.state = self._load_state()

    # --------------------------------------------------------------- state
    def _load_state(self) -> dict:
        if self.state_path.exists():
            return json.loads(self.state_path.read_text())
        return {"visited": {}, "failed": [], "queue": []}

    def _save_state(self):
        self.out.mkdir(parents=True, exist_ok=True)
        self.state_path.write_text(json.dumps(self.state))

    # --------------------------------------------------------------- crawl
    def crawl(self, seeds: list[str]) -> dict:
        cfg = self.config
        queue: list[tuple[str, int]] = [
            tuple(x) for x in self.state.get("queue", [])
        ] or [(s, 0) for s in seeds]
        visited = self.state["visited"]
        n_new = 0
        while queue and len(visited) < cfg.max_pages:
            url, depth = queue.pop(0)
            if url in visited or depth > cfg.max_depth:
                continue
            result = self.fetch(url)
            if result.status != 200:
                self.state["failed"].append(
                    {"url": url, "status": result.status}
                )
                visited[url] = {"status": result.status}
                continue
            meta = self._store(url, result, depth)
            visited[url] = meta
            n_new += 1
            if meta["kind"] == "html" and depth < cfg.max_depth:
                for link in self._extract_links(result.content, url):
                    if link not in visited:
                        queue.append((link, depth + 1))
            self.state["queue"] = queue
            if n_new % 25 == 0:
                self._save_state()
            if cfg.delay_s:
                time.sleep(cfg.delay_s)
        self.state["queue"] = []
        self._save_state()
        return {"n_fetched": n_new, "n_failed": len(self.state["failed"]),
                "n_total": len(visited)}

    def _store(self, url: str, result: FetchResult, depth: int) -> dict:
        parsed = urllib.parse.urlparse(url)
        ext = pathlib.Path(parsed.path).suffix.lower()
        kind = _DOC_EXTENSIONS.get(ext)
        if kind is None:
            kind = "html" if "html" in result.content_type or not ext \
                else "other"
        safe = re.sub(r"[^a-zA-Z0-9._-]+", "_", parsed.path.strip("/"))[:150]
        name = safe or "index"
        if parsed.query:
            # distinct query strings (?page=2 …) must not overwrite each
            # other's files: disambiguate with a short URL hash
            import hashlib

            name += "_" + hashlib.sha256(
                url.encode()).hexdigest()[:10]
        suffix = ext if ext else ".html"
        target = self.out / kind / f"{name}{'' if name.endswith(suffix) else suffix}"
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(result.content)
        meta = {
            "url": url, "kind": kind, "path": str(target),
            "depth": depth, "status": result.status,
            "content_type": result.content_type,
            "last_modified": result.last_modified,
            "etag": result.etag,
            "fetched_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "size": len(result.content),
        }
        target.with_suffix(target.suffix + ".meta.json").write_text(
            json.dumps(meta, ensure_ascii=False)
        )
        return meta

    def _extract_links(self, html: bytes, base_url: str) -> list[str]:
        from .htmltree import BeautifulSoup

        cfg = self.config
        soup = BeautifulSoup(html, "lxml")
        out = []
        for a in soup.find_all("a", href=True):
            href = urllib.parse.urljoin(base_url, a["href"])
            href = href.split("#", 1)[0]
            if href.startswith(cfg.scope_prefix):
                out.append(href)
        return list(dict.fromkeys(out))

    # ------------------------------------------------------------ backfill
    def backfill_metadata(self) -> dict:
        """Enrich existing per-file metadata WITHOUT any HTTP request
        (reference `cnil_scraper_final.py:787-863`): add the content
        hash and url hash when missing, extract publication dates from
        stored HTML, harmonize the timestamp field, and stamp the schema
        version. Used to migrate corpora scraped by older versions."""
        import hashlib

        stats = {"processed": 0, "updated": 0, "errors": 0}
        for meta_file in sorted(self.out.rglob("*.meta.json")):
            try:
                meta = json.loads(meta_file.read_text())
                file_path = pathlib.Path(meta.get("path", ""))
                if not file_path.exists():
                    continue
                stats["processed"] += 1
                updated = False
                if not meta.get("content_hash"):
                    meta["content_hash"] = hashlib.sha256(
                        file_path.read_bytes()).hexdigest()
                    updated = True
                if not meta.get("published_at") and \
                        meta.get("kind") == "html":
                    dates = extract_page_dates(file_path.read_bytes())
                    if dates.get("published_at"):
                        meta["published_at"] = dates["published_at"]
                        meta["page_dates"] = dates
                        updated = True
                if not meta.get("fetched_at") and meta.get("scraped_at"):
                    meta["fetched_at"] = meta["scraped_at"]
                    updated = True
                if not meta.get("url_hash") and meta.get("url"):
                    meta["url_hash"] = hashlib.sha256(
                        meta["url"].encode()).hexdigest()[:16]
                    updated = True
                if meta.get("schema_version") != "v2":
                    meta["schema_version"] = "v2"
                    updated = True
                if updated:
                    stats["updated"] += 1
                    meta_file.write_text(
                        json.dumps(meta, ensure_ascii=False))
                    url = meta.get("url")
                    if url and url in self.state["visited"]:
                        self.state["visited"][url] = meta
            except Exception:  # corrupt metadata: skip, keep going
                stats["errors"] += 1
        self._save_state()
        return stats

    # -------------------------------------------------------------- update
    def update_existing(self) -> dict:
        """Conditional re-fetch of everything visited: 304 → untouched,
        200 → re-stored and reported as changed."""
        changed, unchanged, failed = [], 0, 0
        for url, meta in list(self.state["visited"].items()):
            if meta.get("status") != 200:
                continue
            result = self.fetch(
                url, if_modified_since=meta.get("last_modified", "")
            )
            if result.status == 304:
                unchanged += 1
            elif result.status == 200:
                new_meta = self._store(url, result,
                                       meta.get("depth", 0))
                self.state["visited"][url] = new_meta
                changed.append(url)
            else:
                failed += 1
        self._save_state()
        return {"changed": changed, "n_unchanged": unchanged,
                "n_failed": failed}
