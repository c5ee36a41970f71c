"""An HTML tree on the standard library, with the part of BeautifulSoup's
interface that `ingest/parsing.py` and `ingest/scraper.py` use.

The JAX package parses pages with `BeautifulSoup(data, "lxml")`; neither
bs4 nor lxml is installed beside the port's CUDA stack, so the port's two
copies take `BeautifulSoup` from here and keep their code as it is. The
tree follows what bs4 over lxml (libxml2's HTML parser) builds for the
markup the system reads:

* bytes are decoded as bs4 has lxml decode them: by a byte-order mark,
  else by an XML declaration or a `<meta ... charset=...>` near the
  start, else as UTF-8 with what is not replaced;
* tag and attribute names are lower case; the first of two equal
  attributes wins; `class` holds a list of names;
* void elements (`br`, `img`, `meta`, ...) take no children;
* a start tag closes the open element that libxml2's start-close table
  says it closes (`<p>` by a block, `<li>` by `<li>`, a cell by a cell or
  a row, `<option>` by `<option>`, ...), again while the new current
  element is one such;
* an end tag closes every element down to the nearest open one of its
  name, unless an element of higher end priority (`div`, a table part,
  `body`, `html`) lies between; an end tag with nothing open to close is
  dropped;
* text on both sides of a dropped tag is one string; comments, doctypes
  and processing instructions part strings but are none;
* `get_text` joins the strings below a tag as bs4 does, and the text of
  `script`, `style`, `template`, `rt` and `rp` counts only within an
  element of that name.

`tests/test_torch_htmltree.py` holds every section and link that the
parser and the scraper draw from it equal to bs4 over lxml.
"""

from __future__ import annotations

import codecs
import re
from html.parser import HTMLParser
from typing import Iterator

VOID = frozenset(
    "area base basefont br col embed frame hr img input isindex keygen "
    "link meta param source track wbr".split())
# bs4 gives the strings inside these their own class; a tag's get_text
# keeps only strings of its own class
STRING_CONTAINERS = frozenset(("script", "style", "template", "rt", "rp"))
_HEAD_ELEMENTS = frozenset(("base", "link", "meta", "script", "style",
                            "title"))
# the start tags that close an open head (HTML 4's body elements; newer
# ones such as header or nav open inside it)
_CLOSE_HEAD = frozenset(
    "a abbr acronym address b bdo big blockquote body br center cite code "
    "dd dfn dir div dl dt em fieldset font form frameset h1 h2 h3 h4 h5 h6 "
    "hr i iframe img kbd label li map menu object ol p pre q s samp small "
    "span strike strong table tt u ul var xmp".split())
_HEADINGS = ("h1", "h2", "h3", "h4", "h5", "h6")
_BLOCKS_CLOSING_P = (
    "address", "blockquote", "body", "caption", "center", "col",
    "colgroup", "dd", "dir", "div", "dl", "dt", "fieldset", "form",
    "frameset", "head", "hr", "li", "listing", "menu", "ol", "p", "pre",
    "table", "tbody", "td", "tfoot", "th", "title", "tr", "ul", "xmp",
    *_HEADINGS)
# current element -> the start tags that close it (libxml2's
# htmlStartClose, as its pairs (old, new))
_START_CLOSE: dict[str, frozenset] = {
    "a": frozenset(("a", "fieldset", "table", "td", "th")),
    "address": frozenset(("dd", "dl", "dt", "form", "li", "ul")),
    "b": frozenset(("center", "p", "td", "th")),
    "big": frozenset(("p",)),
    "caption": frozenset(("col", "colgroup", "tbody", "tfoot", "thead",
                          "tr")),
    "col": frozenset(("col", "colgroup", "tbody", "tfoot", "thead", "tr")),
    "colgroup": frozenset(("colgroup", "tbody", "tfoot", "thead", "tr")),
    "dd": frozenset(("dt",)),
    "dir": frozenset(("dd", "dl", "dt", "form", "ul")),
    "dl": frozenset(("form", "li")),
    "dt": frozenset(("dd", "dl")),
    "font": frozenset(("center", "td", "th")),
    "form": frozenset(("form",)),
    "i": frozenset(("center", "p", "td", "th")),
    "legend": frozenset(("fieldset",)),
    "li": frozenset(("li",)),
    "menu": frozenset(("dd", "dl", "dt", "form", "ul")),
    "option": frozenset(("optgroup", "option")),
    "p": frozenset(_BLOCKS_CLOSING_P),
    "pre": frozenset(("dd", "dl", "dt", "fieldset", "form", "li", "table",
                      "ul")),
    "s": frozenset(("p",)),
    "small": frozenset(("p",)),
    "span": frozenset(("td", "th")),
    "strike": frozenset(("p",)),
    "tbody": frozenset(("tbody", "tfoot")),
    "td": frozenset(("tbody", "td", "tfoot", "th", "tr")),
    "tfoot": frozenset(("tbody",)),
    "th": frozenset(("tbody", "td", "tfoot", "th", "tr")),
    "thead": frozenset(("tbody", "tfoot")),
    "tr": frozenset(("tbody", "tfoot", "tr")),
    "tt": frozenset(("p",)),
    "u": frozenset(("p", "td", "th")),
    "ol": frozenset(("form",)),
    "ul": frozenset(("address", "form", "menu", "pre")),
    **{h: frozenset(("fieldset", "form", "li", "p", "table"))
       for h in _HEADINGS},
}
# libxml2's htmlGetEndPriority: an end tag closes no element of a higher
# priority than its own
_END_PRIORITY = {"div": 150, "td": 160, "th": 160, "tr": 170,
                 "thead": 180, "tbody": 180, "tfoot": 180, "table": 190,
                 "head": 200, "body": 200, "html": 220}
_XML_DECL = re.compile(rb"^\s*<\?.*encoding=['\"](.*?)['\"].*\?>", re.I)
_META_CHARSET = re.compile(
    rb"<\s*meta[^>]+charset\s*=\s*[\"']?([^>]*?)[ /;'\">]", re.I)
_BOMS = ((codecs.BOM_UTF8, "utf-8"), (codecs.BOM_UTF32_LE, "utf-32-le"),
         (codecs.BOM_UTF32_BE, "utf-32-be"), (codecs.BOM_UTF16_LE, "utf-16-le"),
         (codecs.BOM_UTF16_BE, "utf-16-be"))


def decode_markup(data: bytes) -> str:
    """The page's text: its byte-order mark's encoding, else the one it
    declares near its start, else UTF-8 (lxml replaces what is not)."""
    for bom, encoding in _BOMS:
        if data.startswith(bom):
            return data[len(bom):].decode(encoding, errors="replace")
    found = _XML_DECL.search(data, 0, 1024) or _META_CHARSET.search(
        data, 0, max(2048, len(data) // 20))
    if found:
        try:
            return data.decode(found.group(1).decode("ascii", "replace"))
        except (LookupError, UnicodeDecodeError):
            pass
    return data.decode("utf-8", errors="replace")


class NavigableString(str):
    """A text node; `container` names the string-container element it
    lies in (None outside any)."""

    name = None
    container: str | None = None


class Comment(str):
    """A comment, doctype or processing instruction: no string of the
    text, but it parts the strings around it, as in libxml2's tree."""

    name = None


class Tag:
    def __init__(self, name: str, attrs: dict, parent: "Tag | None" = None):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.contents: list = []
        self.interesting = name if name in STRING_CONTAINERS else None

    # ------------------------------------------------------------ access
    def __getitem__(self, key: str):
        return self.attrs[key]

    def __getattr__(self, name: str):
        # soup.body, soup.title, ...: the first descendant of that name
        if name.startswith("_"):
            raise AttributeError(name)
        return self.find(name)

    @property
    def descendants(self) -> Iterator:
        stack = list(reversed(self.contents))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, Tag):
                stack.extend(reversed(node.contents))

    def get_text(self, separator: str = "", strip: bool = False) -> str:
        parts = []
        for node in self.descendants:
            if isinstance(node, NavigableString) \
                    and node.container == self.interesting:
                text = node.strip() if strip else str(node)
                if text or not strip:
                    parts.append(text)
        return separator.join(parts)

    # ------------------------------------------------------------ search
    def find_all(self, name=None, attrs: dict | None = None,
                 **kwargs) -> list["Tag"]:
        names = None if name is None else (
            {name} if isinstance(name, str) else set(name))
        wanted = {**(attrs or {}), **kwargs}
        return [node for node in self.descendants
                if isinstance(node, Tag)
                and (names is None or node.name in names)
                and all(_attr_matches(node.attrs.get(key), want)
                        for key, want in wanted.items())]

    __call__ = find_all

    def find(self, name=None, attrs: dict | None = None, **kwargs):
        found = self.find_all(name, attrs, **kwargs)
        return found[0] if found else None

    def decompose(self) -> None:
        """Detach this element and everything below it."""
        if self.parent is not None:
            self.parent.contents = [c for c in self.parent.contents
                                    if c is not self]
            self.parent = None


def _attr_matches(value, want) -> bool:
    if want is True:
        return value is not None
    if value is None:
        return False
    values = value if isinstance(value, list) else [value]
    if isinstance(value, list):
        values = [*value, " ".join(value)]
    for v in values:
        if hasattr(want, "search"):
            if want.search(v):
                return True
        elif v == want:
            return True
    return False


class _TreeBuilder(HTMLParser):
    def __init__(self, root: Tag):
        super().__init__(convert_charrefs=True)
        self.root = root
        self.stack: list[Tag] = [root]
        self.seen: set[str] = set()

    @property
    def current(self) -> Tag:
        return self.stack[-1]

    def handle_starttag(self, tag, attrs):
        if self._open(tag, attrs) and tag in VOID:
            self.stack.pop()

    def handle_startendtag(self, tag, attrs):
        if self._open(tag, attrs):
            self.stack.pop()

    def _push(self, tag: str, attrs: dict) -> None:
        node = Tag(tag, attrs, self.current)
        self.current.contents.append(node)
        self.stack.append(node)
        self.seen.add(tag)

    def _imply(self, tag: str | None) -> None:
        """libxml2's implied elements: an `html` around anything, a `head`
        around the head's elements before the body, a `body` around the
        rest; a body element or text closes an open head. `tag` None is
        text."""
        if self.current is self.root:
            self._push("html", {})
        if tag in _HEAD_ELEMENTS:
            if self.current.name == "html" and not self.seen & {
                    "head", "body"}:
                self._push("head", {})
            return
        if self.current.name == "head":
            if tag is not None and tag not in _CLOSE_HEAD:
                return
            self.stack.pop()
        if self.current.name == "html" and "body" not in self.seen:
            self._push("body", {})

    def _open(self, tag, attrs) -> bool:
        """Opens `tag` where libxml2 would; False where it drops it (a
        second `html` or `body`, a `head` once the body has begun)."""
        if tag == "html" and "html" in self.seen \
                or tag == "body" and "body" in self.seen \
                or tag == "head" and self.seen & {"head", "body"}:
            return False
        if tag in ("head", "body"):
            if self.current is self.root:
                self._push("html", {})
        elif tag != "html":
            self._imply(tag)
        while len(self.stack) > 1 \
                and tag in _START_CLOSE.get(self.current.name, ()):
            self.stack.pop()
        values: dict = {}
        for key, value in attrs:
            if key not in values:
                value = "" if value is None else value
                values[key] = value.split() if key == "class" else value
        self._push(tag, values)
        return True

    def handle_endtag(self, tag):
        priority = _END_PRIORITY.get(tag, 100)
        for i in range(len(self.stack) - 1, 0, -1):
            name = self.stack[i].name
            if name == tag:
                del self.stack[i:]
                return
            if _END_PRIORITY.get(name, 100) > priority:
                return

    def handle_data(self, data):
        if self.current is self.root:
            data = data.lstrip()  # blanks before the document are dropped
        if not data.strip():
            if self.current is self.root:
                return
        else:
            self._imply(None)
        contents = self.current.contents
        if contents and isinstance(contents[-1], NavigableString):
            # libxml2 joins the text on both sides of a dropped tag
            data = contents.pop() + data
        text = NavigableString(data)
        text.container = next(
            (t.name for t in reversed(self.stack)
             if t.name in STRING_CONTAINERS), None)
        contents.append(text)

    def handle_comment(self, data):
        if self.current is not self.root:
            self.current.contents.append(Comment(data))

    handle_decl = handle_pi = handle_comment


def BeautifulSoup(markup, features: str = "lxml") -> Tag:  # noqa: N802
    """The document tree of `markup` (bytes or text). `features` is taken
    for the JAX call's signature; the tree is always this module's."""
    text = markup if isinstance(markup, str) else decode_markup(markup)
    root = Tag("[document]", {})
    builder = _TreeBuilder(root)
    builder.feed(text)
    builder.close()
    return root
