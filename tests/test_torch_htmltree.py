"""The port's HTML tree (`ingest/htmltree.py`) against bs4 over lxml.

The JAX package parses HTML with `BeautifulSoup(data, "lxml")`, which the
card's machine does not have; the port's parser and scraper copies take
their tree from `htmltree`. Held here, on pages the corpus build reads and
on tag soup: the sections `parse_document` draws and the links the scraper
follows equal the JAX package's, and the tree itself (elements, their
order and nesting, and text, comments aside) equals the one bs4 builds
over lxml.
"""

import random

import bs4
import pytest

from fixture_docs import make_docx, make_ods, make_odt, make_pdf, make_xlsx
from rag_dpo_tpu.ingest.parsing import parse_document as j_parse_document
from rag_dpo_tpu.ingest.scraper import Scraper as JScraper
from rag_dpo_tpu_torch.evals.fake_site import render_pages
from rag_dpo_tpu_torch.ingest import htmltree
from rag_dpo_tpu_torch.ingest.parsing import parse_document
from rag_dpo_tpu_torch.ingest.scraper import Scraper
from test_ingest import HTML_DOC
from test_ingest_e2e import PAGES

MESSY = [
    "hello",
    "<p>a<div>b</div>c</p>",
    "<div/>x<span/>y",
    "<br/>a<script/>b",
    "<title>T</title><p>x",
    "<ul><li>a<li>b</ul>",
    "<table><tr><td>a<td>b<tr><td>c</table>",
    "<b><div>x</b>y</div>",
    "<div><span>t</div>u",
    "</p>x",
    "<p>a<b>b<p>c",
    "<h2>a<p>b</h2>c",
    "<li>a<p>b<li>c",
    "<a href=x>1<a href=y>2",
    "text<head><title>x</title></head>",
    "<select><option>1<option>2</select>",
    "<dl><dt>a<dd>b<dt>c</dl>",
    "<div class='a b' class='c'>x</div>",
    "<template><p>x</p></template>y",
    "<p>&nbsp;&amp;&eacute;&#233;&#xE9;</p>",
    "<!-- c --><p>x<!-- y -->z</p>",
    "<!DOCTYPE html><p>x</p>",
    "<table><p>x</p><tr><td>y</td></tr></table>",
    "<form><form>x</form></form>",
    "<p><table><tr><td>x</td></tr></table>",
    "<h1><h2>x</h2></h1>",
    "<body>a</body><p>after</p>",
    "<div>x</span>y</div>",
    "<textarea><p>x</p></textarea>",
    "<p>x<ul><li>y</ul>",
    "<ol><li>a<ol><li>b</ol><li>c</ol>",
    "<head><header>x</header></head><p>y",
    "<ul>x<menu>y", "<address>x<ul>y", "<dir>x<ul>y",
    "<meta charset=utf-8><p>é</p>",
    "<div id='main-content'><nav>menu</nav><h2>A</h2><p>x</p></div>"
    "<footer>f</footer>",
    "<div class='article-content'><h3>T</h3><ul><li>un</li><li>deux"
    "</li></ul><blockquote>c</blockquote><pre>p\n q</pre></div>",
]
TAGS = ["p", "div", "span", "b", "i", "a", "ul", "ol", "li", "h1", "h2",
        "h3", "table", "tr", "td", "th", "tbody", "thead", "blockquote",
        "pre", "br", "img", "section", "article", "nav", "header", "footer",
        "em", "strong", "dl", "dt", "dd", "form", "script", "style", "main",
        "aside", "option", "select", "font", "center", "hr", "code",
        "caption", "small", "u", "menu", "fieldset", "legend"]


def tag_soup(seed: int, n: int = 200) -> list[str]:
    """Random start, end and self-closed tags among French text."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(1, 12)):
            r, tag = rng.random(), rng.choice(TAGS)
            if r < 0.4:
                parts.append(f"<{tag}>")
            elif r < 0.65:
                parts.append(f"</{tag}>")
            elif r < 0.7:
                parts.append(f"<{tag}/>")
            else:
                parts.append(rng.choice(["texte", "données é", " ", "\n",
                                         "&amp;", "x y"]))
        out.append("".join(parts))
    return out


def bs4_tree(node) -> list:
    return _merged([(c.name, bs4_tree(c)) if isinstance(c, bs4.Tag)
                    else str(c) for c in node.children
                    if not isinstance(c, (bs4.Comment, bs4.Doctype,
                                          bs4.Declaration,
                                          bs4.ProcessingInstruction))])


def port_tree(node) -> list:
    return _merged([(c.name, port_tree(c)) if isinstance(c, htmltree.Tag)
                    else str(c) for c in node.contents
                    if not isinstance(c, htmltree.Comment)])


def _merged(items) -> list:
    """Adjacent strings joined, blank ones dropped (libxml2 keeps some
    blanks html.parser also keeps, in other places; no caller reads a
    blank string)."""
    out = []
    for it in items:
        if isinstance(it, str) and out and isinstance(out[-1], str):
            out[-1] += it
        else:
            out.append(it)
    return [x for x in out if not (isinstance(x, str) and not x.strip())]


def smoke_pages() -> dict:
    chunks = [{"chunk_id": f"c{i}", "heading": f"Titre {i % 7}",
               "title": f"Fiche {i % 5} & co", "text": text}
              for i, text in enumerate([
                  "L'article 33 du RGPD impose <la notification> en 72 h.",
                  "Données « sensibles » : santé, opinions… et biométrie.",
                  "Le DPO tient le registre des traitements.",
                  "Sous-traitant & responsable : article 28."] * 3)]
    return render_pages(chunks, 5)


PAGE_SETS = {
    "e2e": list(PAGES.values()),
    "ingest": [HTML_DOC.decode()],
    "fake_site": list(smoke_pages().values()),
    "messy": MESSY,
}


@pytest.mark.parametrize("name", sorted(PAGE_SETS))
def test_sections_equal_jax(name):
    for page in PAGE_SETS[name]:
        data = page.encode()
        assert parse_document(data, "html") \
            == _as_port(j_parse_document(data, "html")), page


def _as_port(sections):
    """JAX sections as the port's dataclasses (equal fields)."""
    from rag_dpo_tpu_torch.ingest.parsing import Section, Table

    return [Section(s.heading, s.text, s.level, s.page_info,
                    [Table(t.headers, t.rows) for t in s.tables])
            for s in sections]


@pytest.mark.parametrize("name", sorted(PAGE_SETS))
def test_links_equal_jax(name, tmp_path):
    port = Scraper(tmp_path / "t")
    jax_side = JScraper(tmp_path / "j")
    for page in PAGE_SETS[name]:
        for base in ("https://www.cnil.fr/fr/", "http://127.0.0.1:8000/fr/"):
            assert port._extract_links(page.encode(), base) \
                == jax_side._extract_links(page.encode(), base)


@pytest.mark.parametrize("case", range(len(MESSY)))
def test_tree_equals_bs4_on_messy_markup(case):
    data = MESSY[case].encode()
    assert port_tree(htmltree.BeautifulSoup(data)) \
        == bs4_tree(bs4.BeautifulSoup(data, "lxml"))


@pytest.mark.parametrize("seed", range(4))
def test_tree_equals_bs4_on_tag_soup(seed):
    for soup in tag_soup(seed):
        data = soup.encode()
        assert port_tree(htmltree.BeautifulSoup(data)) \
            == bs4_tree(bs4.BeautifulSoup(data, "lxml")), soup


@pytest.mark.parametrize("data,text", [
    ("é".encode("utf-8"), "é"),
    ('<meta charset="iso-8859-1"><p>é</p>'.encode("latin-1"), "é"),
    ("<p>é</p>".encode("cp1252"), "\ufffd"),
    (b"\xef\xbb\xbf<p>\xc3\xa9</p>", "é"),
])
def test_decoding_as_bs4(data, text):
    got = htmltree.BeautifulSoup(data).get_text(strip=True)
    assert got == bs4.BeautifulSoup(data, "lxml").get_text(strip=True) \
        == text


@pytest.mark.parametrize("make,fmt", [
    (make_docx, "docx"), (make_xlsx, "xlsx"), (make_odt, "odt"),
    (make_ods, "ods"), (make_pdf, "pdf")])
def test_binary_formats_equal_jax(make, fmt):
    data = make()
    assert parse_document(data, fmt) == _as_port(j_parse_document(data, fmt))
