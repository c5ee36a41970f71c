"""Pure-stdlib Office parsers: DOCX / XLSX / ODT / ODS → Sections.

The reference parses these with python-docx / openpyxl / odfpy
(`src/processing/process_and_chunk.py:908-957` DOCX DOM-ordered walk,
:631-746 spreadsheet zone segmentation). Those libraries are absent from
this image and nothing may be installed — but every one of these formats
is just a ZIP of XML, so the parsers here read them with zipfile +
xml.etree directly. Semantics match the reference:

* DOCX — body elements walked IN DOCUMENT ORDER (paragraphs AND tables
  interleaved, the reference's `w:tbl` walk), heading styles split
  sections;
* XLSX/ODS — each sheet segmented into zones on blank rows, first zone
  row = headers;
* ODT — heading elements split sections, tables captured in place.

When the richer third-party libraries ARE importable, `parsing.py`
prefers them; these are the always-available floor.
"""

from __future__ import annotations

import io
import re
import zipfile
import xml.etree.ElementTree as ET

from .parsing import Section, Table

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_TEXT = "{urn:oasis:names:tc:opendocument:xmlns:text:1.0}"
_TABLE = "{urn:oasis:names:tc:opendocument:xmlns:table:1.0}"
_OFFICE = "{urn:oasis:names:tc:opendocument:xmlns:office:1.0}"


def _zip_xml(data: bytes, member: str):
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        try:
            return ET.fromstring(z.read(member))
        except KeyError:
            return None


def unparseable_to_value_error(fn):
    """Parser contract: unparseable bytes raise ValueError (the error
    the per-document callers catch and skip) — never BadZipFile /
    ParseError / truncation artifacts that would crash a whole corpus
    run on one corrupt file."""
    import functools

    @functools.wraps(fn)
    def wrapped(data: bytes, *a, **k):
        try:
            return fn(data, *a, **k)
        except (zipfile.BadZipFile, ET.ParseError, OSError,
                UnicodeDecodeError) as e:
            raise ValueError(
                f"unparseable document ({type(e).__name__}: {e})"
            ) from e

    return wrapped


# ---------------------------------------------------------------------- docx

def _w_text(el) -> str:
    return "".join(t.text or "" for t in el.iter(f"{_W}t"))


def _docx_heading_level(p) -> int:
    """0 = body text; 1-4 = heading level from the paragraph style."""
    ppr = p.find(f"{_W}pPr")
    if ppr is None:
        return 0
    style = ppr.find(f"{_W}pStyle")
    if style is None:
        return 0
    val = style.get(f"{_W}val", "")
    m = re.match(r"(?:Heading|Titre)(\d)", val, re.IGNORECASE)
    return int(m.group(1)) if m else 0


def _docx_table(tbl) -> Table:
    rows = []
    for tr in tbl.findall(f"{_W}tr"):
        rows.append([_w_text(tc) for tc in tr.findall(f"{_W}tc")])
    return Table(headers=rows[0] if rows else [], rows=rows[1:])


@unparseable_to_value_error
def parse_docx(data: bytes) -> list[Section]:
    root = _zip_xml(data, "word/document.xml")
    if root is None:
        return []
    body = root.find(f"{_W}body")
    if body is None:
        return []
    sections: list[Section] = []
    current = Section("", "", 0)
    parts: list[str] = []

    def flush():
        nonlocal current, parts
        current.text = "\n".join(parts).strip()
        if current.text or current.tables:
            sections.append(current)
        parts = []

    for el in body:  # document order: w:p and w:tbl interleaved
        if el.tag == f"{_W}p":
            level = _docx_heading_level(el)
            text = _w_text(el).strip()
            if level:
                flush()
                current = Section(text, "", level)
            elif text:
                parts.append(text)
        elif el.tag == f"{_W}tbl":
            current.tables.append(_docx_table(el))
    flush()
    return sections


# ---------------------------------------------------------------------- xlsx

def _xlsx_shared_strings(data: bytes) -> list[str]:
    root = _zip_xml(data, "xl/sharedStrings.xml")
    if root is None:
        return []
    out = []
    for si in root.findall(f"{_S}si"):
        out.append("".join(t.text or "" for t in si.iter(f"{_S}t")))
    return out


def _col_index(ref: str) -> int:
    """'C7' → 2 (zero-based column)."""
    n = 0
    for ch in ref:
        if ch.isalpha():
            n = n * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return n - 1


def _zones_to_sections(title: str, grid: list[list[str]]) -> list[Section]:
    """Blank-row zone segmentation shared by xlsx and ods (reference
    `process_and_chunk.py:631-679`)."""
    zones: list[list[list[str]]] = [[]]
    for cells in grid:
        if not any(c.strip() for c in cells):
            if zones[-1]:
                zones.append([])
        else:
            zones[-1].append(cells)
    sections = []
    for zi, zone in enumerate(z for z in zones if z):
        sections.append(Section(
            heading=f"{title} — zone {zi + 1}", text="", level=2,
            tables=[Table(headers=zone[0], rows=zone[1:])],
        ))
    return sections


@unparseable_to_value_error
def parse_xlsx(data: bytes) -> list[Section]:
    shared = _xlsx_shared_strings(data)
    wb = _zip_xml(data, "xl/workbook.xml")
    names = []
    if wb is not None:
        for sh in wb.iter(f"{_S}sheet"):
            names.append(sh.get("name", f"Sheet{len(names) + 1}"))
    sections: list[Section] = []
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        members = sorted(
            m for m in z.namelist()
            if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", m)
        )
        for i, member in enumerate(members):
            root = ET.fromstring(z.read(member))
            grid: list[list[str]] = []
            last_row = 0
            for row in root.iter(f"{_S}row"):
                r = int(row.get("r", last_row + 1))
                while last_row + 1 < r:  # blank rows are omitted in xml
                    grid.append([])
                    last_row += 1
                cells: list[str] = []
                for c in row.findall(f"{_S}c"):
                    col = _col_index(c.get("r", ""))
                    v = c.find(f"{_S}v")
                    raw = v.text if v is not None and v.text else ""
                    if c.get("t") == "s" and raw:
                        raw = shared[int(raw)]
                    while len(cells) < col:
                        cells.append("")
                    cells.append(raw)
                grid.append(cells)
                last_row = r
            title = names[i] if i < len(names) else f"Sheet{i + 1}"
            sections.extend(_zones_to_sections(title, grid))
    return sections


# ----------------------------------------------------------------- odt / ods

def _odf_text(el) -> str:
    return "".join(el.itertext())


@unparseable_to_value_error
def parse_odt(data: bytes) -> list[Section]:
    root = _zip_xml(data, "content.xml")
    if root is None:
        return []
    body = root.find(f"{_OFFICE}body/{_OFFICE}text")
    if body is None:
        return []
    sections: list[Section] = []
    current = Section("", "", 0)
    parts: list[str] = []

    def flush():
        nonlocal current, parts
        current.text = "\n".join(parts).strip()
        if current.text or current.tables:
            sections.append(current)
        parts = []

    for el in body:
        if el.tag == f"{_TEXT}h":
            flush()
            current = Section(
                _odf_text(el).strip(), "",
                int(el.get(f"{_TEXT}outline-level", "1")),
            )
        elif el.tag == f"{_TEXT}p":
            t = _odf_text(el).strip()
            if t:
                parts.append(t)
        elif el.tag == f"{_TABLE}table":
            rows = []
            for tr in el.iter(f"{_TABLE}table-row"):
                rows.append([
                    _odf_text(tc).strip()
                    for tc in tr.findall(f"{_TABLE}table-cell")
                ])
            current.tables.append(
                Table(headers=rows[0] if rows else [], rows=rows[1:]))
    flush()
    return sections


@unparseable_to_value_error
def parse_ods(data: bytes) -> list[Section]:
    root = _zip_xml(data, "content.xml")
    if root is None:
        return []
    body = root.find(f"{_OFFICE}body/{_OFFICE}spreadsheet")
    if body is None:
        return []
    sections: list[Section] = []
    for table in body.findall(f"{_TABLE}table"):
        title = table.get(f"{_TABLE}name", "Feuille")
        grid: list[list[str]] = []
        for tr in table.findall(f"{_TABLE}table-row"):
            repeat = int(tr.get(
                f"{_TABLE}number-rows-repeated", "1"))
            cells: list[str] = []
            for tc in tr.findall(f"{_TABLE}table-cell"):
                crep = int(tc.get(
                    f"{_TABLE}number-columns-repeated", "1"))
                cells.extend([_odf_text(tc).strip()] * min(crep, 64))
            for _ in range(min(repeat, 64)):
                grid.append(list(cells))
        sections.extend(_zones_to_sections(title, grid))
    return sections
