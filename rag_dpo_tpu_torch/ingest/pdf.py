"""Minimal pure-Python PDF text extraction + infographic vision fallback.

The reference extracts PDF text with PyMuPDF and falls back to LLaVA
vision for infographic PDFs with no text layer
(`src/processing/process_and_chunk.py:283-516`). PyMuPDF is absent from
this image, so this module implements the subset the corpus pipeline
needs directly on the PDF object syntax (stdlib + zlib only):

* object scan — lenient `N 0 obj … endobj` parse, no xref required
  (real-world CNIL PDFs frequently have broken xref tables anyway);
* FlateDecode stream decompression;
* page order from the /Pages tree (/Kids), content from /Contents;
* text from BT…ET blocks: Tj, ' and TJ operators, literal ( ) strings
  with escapes and <hex> strings;
* heading detection from Tf font sizes (the reference's font-size
  heading heuristic, :368-411) — sizes ≥ `heading_size` start sections;
* outline (TOC) titles when present;
* vision fallback — a PDF whose pages carry no extractable text is an
  infographic/scan: each page is handed to the injectable `vision`
  callable (LLaVA-class provider in production, a fake in tests) and the
  returned description becomes that page's section text (:413-516).
"""

from __future__ import annotations

import re
import zlib
from typing import Callable

from .parsing import Section

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj(.*?)endobj", re.DOTALL)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_MIN_TEXT_CHARS = 25  # below this across ALL pages → infographic/scan


def _objects(data: bytes) -> dict[int, bytes]:
    return {int(m.group(1)): m.group(3) for m in _OBJ_RE.finditer(data)}


def _stream_of(obj: bytes) -> bytes | None:
    m = _STREAM_RE.search(obj)
    if m is None:
        return None
    raw = m.group(1)
    if b"/FlateDecode" in obj:
        try:
            return zlib.decompress(raw)
        except zlib.error:
            return None
    return raw


def _refs(obj: bytes, key: bytes) -> list[int]:
    """Object numbers referenced by `/Key N 0 R` or `/Key [N 0 R …]`."""
    m = re.search(key + rb"\s*\[(.*?)\]", obj, re.DOTALL)
    if m:
        return [int(x) for x in re.findall(rb"(\d+)\s+0\s+R", m.group(1))]
    m = re.search(key + rb"\s*(\d+)\s+0\s+R", obj)
    return [int(m.group(1))] if m else []


def _unescape(body: bytes) -> str:
    out = []
    i = 0
    while i < len(body):
        c = body[i:i + 1]
        if c == b"\\" and i + 1 < len(body):
            nxt = body[i + 1:i + 2]
            if nxt in b"nrtbf":
                out.append({"n": "\n", "r": "\r", "t": "\t",
                            "b": "\b", "f": "\f"}[nxt.decode()])
                i += 2
            elif nxt.isdigit():
                oct_digits = re.match(rb"\\([0-7]{1,3})", body[i:])
                if oct_digits is None:  # \8 / \9: invalid octal — literal
                    out.append(nxt.decode("latin-1"))
                    i += 2
                else:
                    out.append(chr(int(oct_digits.group(1), 8)))
                    i += 1 + len(oct_digits.group(1))
            else:
                out.append(nxt.decode("latin-1"))
                i += 2
        else:
            out.append(c.decode("latin-1"))
            i += 1
    return "".join(out)


_TEXT_OP = re.compile(
    rb"\((?P<lit>(?:[^()\\]|\\.)*)\)\s*(?:Tj|')"      # (…) Tj   (…) '
    rb"|<(?P<hex>[0-9A-Fa-f\s]+)>\s*Tj"               # <hex> Tj
    rb"|\[(?P<arr>(?:[^\[\]\\]|\\.)*)\]\s*TJ"         # [(…) -5 (…)] TJ
    rb"|/\w+\s+(?P<size>[\d.]+)\s+Tf"                 # font size
    rb"|(?P<nl>T\*|TD|Td|TL)"                          # line moves
)
_ARR_LIT = re.compile(rb"\((?:[^()\\]|\\.)*\)")


def _decode_hex(h: bytes) -> str:
    h = re.sub(rb"\s", b"", h)
    if len(h) % 2:
        h += b"0"
    raw = bytes.fromhex(h.decode())
    if raw[:2] in (b"\xfe\xff",):
        return raw[2:].decode("utf-16-be", errors="replace")
    return raw.decode("latin-1")


def _extract_runs(content: bytes) -> list[tuple[float, str]]:
    """→ [(font_size, text_line)] in stream order."""
    runs: list[tuple[float, str]] = []
    size = 0.0
    line: list[str] = []

    def newline():
        text = "".join(line).strip()
        if text:
            runs.append((size, text))
        line.clear()

    for m in _TEXT_OP.finditer(content):
        if m.group("size") is not None:
            newline()
            size = float(m.group("size"))
        elif m.group("lit") is not None:
            line.append(_unescape(m.group("lit")))
        elif m.group("hex") is not None:
            line.append(_decode_hex(m.group("hex")))
        elif m.group("arr") is not None:
            for lit in _ARR_LIT.findall(m.group("arr")):
                line.append(_unescape(lit[1:-1]))
        elif m.group("nl") is not None:
            newline()
    newline()
    return runs


def _page_order(objs: dict[int, bytes]) -> list[int]:
    """Page object numbers in document order via the /Pages tree."""
    kids_of = {}
    pages_roots = []
    for num, obj in objs.items():
        if re.search(rb"/Type\s*/Pages\b", obj):
            kids_of[num] = _refs(obj, rb"/Kids")
            pages_roots.append(num)
        elif re.search(rb"/Type\s*/Catalog\b", obj):
            pass
    order: list[int] = []

    def walk(num):
        for kid in kids_of.get(num, []):
            if kid in kids_of:
                walk(kid)
            else:
                order.append(kid)

    roots = [n for n in pages_roots
             if not any(n in k for k in kids_of.values())]
    for r in roots:
        walk(r)
    if not order:  # no tree: fall back to raw /Type /Page scan order
        order = sorted(
            n for n, o in objs.items()
            if re.search(rb"/Type\s*/Page\b", o)
        )
    return order


def outline_titles(data: bytes) -> list[str]:
    """TOC titles from the /Outlines tree (best-effort, order of objects)."""
    titles = []
    for num, obj in sorted(_objects(data).items()):
        m = re.search(rb"/Title\s*\((?P<t>(?:[^()\\]|\\.)*)\)", obj)
        if m and (b"/Parent" in obj or b"/Dest" in obj or b"/A" in obj):
            titles.append(_unescape(m.group("t")))
    return titles


def parse_pdf(
    data: bytes,
    vision: Callable[[bytes, int], str] | None = None,
    heading_size: float = 14.0,
) -> list[Section]:
    objs = _objects(data)
    page_nums = _page_order(objs)

    page_runs: list[list[tuple[float, str]]] = []
    for pnum in page_nums:
        obj = objs.get(pnum, b"")
        runs: list[tuple[float, str]] = []
        for cnum in _refs(obj, rb"/Contents"):
            stream = _stream_of(objs.get(cnum, b""))
            if stream:
                runs.extend(_extract_runs(stream))
        page_runs.append(runs)

    total_chars = sum(len(t) for runs in page_runs for _, t in runs)
    if total_chars < _MIN_TEXT_CHARS:
        # infographic / scanned PDF: no text layer worth chunking —
        # hand each page to the vision model (reference :413-516)
        if vision is None:
            return []
        sections = []
        seen: set[str] = set()
        for i in range(max(len(page_nums), 1)):
            desc = (vision(data, i) or "").strip()
            # providers without per-page focus return one description
            # for the whole document: collapse duplicates instead of
            # indexing N identical sections
            if desc and desc not in seen:
                seen.add(desc)
                sections.append(Section(
                    heading="", text=desc, level=0,
                    page_info=f"p.{i + 1} (vision)",
                ))
        return sections

    # font-size headings split sections across page boundaries
    sections: list[Section] = []
    current = Section("", "", 0)
    parts: list[str] = []

    def flush():
        nonlocal current, parts
        current.text = "\n".join(parts).strip()
        if current.text or current.heading:
            sections.append(current)
        parts = []

    for page_i, runs in enumerate(page_runs):
        for size, text in runs:
            if size >= heading_size and len(text) < 200:
                flush()
                current = Section(text, "", 2,
                                  page_info=f"p.{page_i + 1}")
            else:
                parts.append(text)
        if not current.page_info:
            current.page_info = f"p.{page_i + 1}"
    flush()
    return [s for s in sections if s.text or s.heading]
