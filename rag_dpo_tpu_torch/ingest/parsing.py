"""Document parsing: format → ordered Sections (host-side CPU work).

Role parity with the reference's per-format extraction inside
`src/processing/process_and_chunk.py` (HTML by h2/h3 within the content
region :109-164, DOCX DOM-ordered walk :908-957, spreadsheet zone
segmentation :631-746, PDF TOC/font-size headings :283-516). Re-designed
as a parser REGISTRY: each format registers only when its parsing library
imports, so missing host deps degrade per-format instead of killing the
pipeline (PyMuPDF/python-docx/openpyxl parsers self-gate).

Port: a copy of `rag_dpo_tpu/ingest/parsing.py` but for where HTML's
`BeautifulSoup` comes from: `ingest/htmltree.py`, a tree on the standard
library, since bs4 and lxml are not installed beside the CUDA stack.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Callable


@dataclasses.dataclass
class Table:
    headers: list[str]
    rows: list[list[str]]


@dataclasses.dataclass
class Section:
    heading: str
    text: str
    level: int = 2
    page_info: str = ""
    tables: list[Table] = dataclasses.field(default_factory=list)


_PARSERS: dict[str, Callable[[bytes], list[Section]]] = {}


def register(*exts: str):
    def deco(fn):
        for ext in exts:
            _PARSERS[ext] = fn
        return fn
    return deco


def supported_formats() -> list[str]:
    return sorted(_PARSERS)


def parse_document(path_or_bytes, fmt: str | None = None,
                   vision=None) -> list[Section]:
    """Parse a document into ordered Sections.

    `vision`: optional callable (pdf_bytes, page_index) → description,
    used by the PDF parser as the infographic/scanned-page fallback when
    no text layer exists (reference `process_and_chunk.py:413-516`)."""
    if isinstance(path_or_bytes, (str, pathlib.Path)):
        path = pathlib.Path(path_or_bytes)
        fmt = fmt or path.suffix.lstrip(".").lower()
        data = path.read_bytes()
    else:
        data = path_or_bytes
        assert fmt, "fmt required for raw bytes"
    parser = _PARSERS.get(fmt.lower())
    if parser is None:
        raise ValueError(
            f"no parser for format '{fmt}' (available: "
            f"{supported_formats()})"
        )
    if vision is not None:
        import inspect

        if "vision" in inspect.signature(parser).parameters:
            return parser(data, vision=vision)
    return parser(data)


# ----------------------------------------------------------------- txt / md

@register("txt")
def _parse_txt(data: bytes) -> list[Section]:
    text = data.decode("utf-8", errors="replace")
    return [Section(heading="", text=text.strip(), level=0)]


@register("md", "markdown")
def _parse_md(data: bytes) -> list[Section]:
    text = data.decode("utf-8", errors="replace")
    sections: list[Section] = []
    heading, level, buf = "", 0, []
    for line in text.splitlines():
        m = re.match(r"(#{1,4})\s+(.*)", line)
        if m:
            if buf and "".join(buf).strip():
                sections.append(Section(heading, "\n".join(buf).strip(),
                                        level))
            heading, level, buf = m.group(2).strip(), len(m.group(1)), []
        else:
            buf.append(line)
    if buf and "".join(buf).strip():
        sections.append(Section(heading, "\n".join(buf).strip(), level))
    return sections or [Section("", text.strip(), 0)]


# --------------------------------------------------------------------- html

_CONTENT_SELECTORS = (
    {"class": re.compile(r"region-content|main-content|article-content")},
    {"id": re.compile(r"content|main")},
)
_SKIP_TAGS = ("nav", "header", "footer", "script", "style", "aside", "form")


@register("html", "htm")
def _parse_html(data: bytes) -> list[Section]:
    from .htmltree import BeautifulSoup

    soup = BeautifulSoup(data, "lxml")
    for tag in soup(_SKIP_TAGS):
        tag.decompose()

    root = None
    for sel in _CONTENT_SELECTORS:
        root = soup.find(attrs=sel)
        if root is not None:
            break
    root = root or soup.body or soup

    sections: list[Section] = []
    title = soup.title.get_text(strip=True) if soup.title else ""
    current = Section(heading=title, text="", level=1)
    parts: list[str] = []

    def flush():
        nonlocal current, parts
        text = "\n".join(p for p in parts if p.strip()).strip()
        if text or current.tables:
            current.text = text
            sections.append(current)
        parts = []

    for el in root.descendants:
        name = getattr(el, "name", None)
        if name in ("h1", "h2", "h3"):
            flush()
            current = Section(
                heading=el.get_text(" ", strip=True),
                text="", level=int(name[1]),
            )
        elif name in ("p", "li", "blockquote", "pre"):
            txt = el.get_text(" ", strip=True)
            if txt:
                parts.append(("- " if name == "li" else "") + txt)
        elif name == "table":
            current.tables.append(_html_table(el))
    flush()
    return [s for s in sections if s.text or s.tables] or [
        Section(title, root.get_text(" ", strip=True), 1)
    ]


def _html_table(el) -> Table:
    rows = []
    for tr in el.find_all("tr"):
        rows.append([td.get_text(" ", strip=True)
                     for td in tr.find_all(["td", "th"])])
    headers = rows[0] if rows else []
    return Table(headers=headers, rows=rows[1:])


# ------------------------------------------------------- binary formats
# Rich third-party parsers are preferred when importable; the pure-stdlib
# implementations in ingest/office.py + ingest/pdf.py register below as
# the always-available floor (this image has none of PyMuPDF/python-docx/
# openpyxl/odfpy and nothing may be installed).

try:  # PDF via PyMuPDF when present
    import fitz  # noqa: F401

    @register("pdf")
    def _parse_pdf(data: bytes) -> list[Section]:
        doc = fitz.open(stream=data, filetype="pdf")
        toc = doc.get_toc()
        sections: list[Section] = []
        if toc:
            for i, (level, heading, page) in enumerate(toc):
                end = toc[i + 1][2] - 1 if i + 1 < len(toc) else doc.page_count
                text = "\n".join(
                    doc[p].get_text() for p in range(page - 1, end)
                )
                sections.append(Section(heading, text.strip(), level,
                                        page_info=f"p.{page}-{end}"))
        else:
            for p in range(doc.page_count):
                sections.append(Section("", doc[p].get_text().strip(), 0,
                                        page_info=f"p.{p + 1}"))
        return [s for s in sections if s.text]
except ImportError:
    pass

try:  # DOCX via python-docx when present
    import docx  # noqa: F401

    @register("docx")
    def _parse_docx(data: bytes) -> list[Section]:
        import io

        d = docx.Document(io.BytesIO(data))
        sections: list[Section] = []
        current = Section("", "", 0)
        parts: list[str] = []
        for para in d.paragraphs:
            style = (para.style.name or "").lower()
            if style.startswith("heading"):
                if parts:
                    current.text = "\n".join(parts).strip()
                    sections.append(current)
                    parts = []
                current = Section(para.text.strip(), "",
                                  int(style[-1]) if style[-1].isdigit()
                                  else 2)
            elif para.text.strip():
                parts.append(para.text.strip())
        if parts:
            current.text = "\n".join(parts).strip()
            sections.append(current)
        return [s for s in sections if s.text]
except ImportError:
    pass

try:  # XLSX via openpyxl when present
    import openpyxl  # noqa: F401

    @register("xlsx")
    def _parse_xlsx(data: bytes) -> list[Section]:
        import io

        wb = openpyxl.load_workbook(io.BytesIO(data), read_only=True,
                                    data_only=True)
        sections: list[Section] = []
        for ws in wb.worksheets:
            # zone segmentation on blank rows (reference :631-679)
            zones: list[list[list[str]]] = [[]]
            for row in ws.iter_rows(values_only=True):
                cells = ["" if c is None else str(c) for c in row]
                if not any(c.strip() for c in cells):
                    if zones[-1]:
                        zones.append([])
                else:
                    zones[-1].append(cells)
            for zi, zone in enumerate(z for z in zones if z):
                table = Table(headers=zone[0], rows=zone[1:])
                sections.append(Section(
                    heading=f"{ws.title} — zone {zi + 1}", text="",
                    level=2, tables=[table],
                ))
        return sections
except ImportError:
    pass


def _register_stdlib_fallbacks():
    """Pure-stdlib parsers fill every format slot the optional libraries
    left empty (including ODT/ODS, which have no third-party path here)."""
    from . import office, pdf as pdf_mod

    if "pdf" not in _PARSERS:
        _PARSERS["pdf"] = pdf_mod.parse_pdf
    if "docx" not in _PARSERS:
        _PARSERS["docx"] = office.parse_docx
    if "xlsx" not in _PARSERS:
        _PARSERS["xlsx"] = office.parse_xlsx
    _PARSERS.setdefault("odt", office.parse_odt)
    _PARSERS.setdefault("ods", office.parse_ods)


_register_stdlib_fallbacks()
