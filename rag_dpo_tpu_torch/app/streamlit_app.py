"""Streamlit multipage web app — feature parity with the reference UI.

Port of `rag_dpo_tpu/app/streamlit_app.py`: the same pages (chat with
agent/native toggle, nature filter, enterprise-tag multiselect, depth
slider, source cards and feedback; the dashboard; the enterprise document
page; the about page), with the device inventory read from torch. Every
page is a plain function taking (st, system), so the whole surface is
testable with a stubbed `st`. Launch (where streamlit exists):
`streamlit run rag_dpo_tpu_torch/app/streamlit_app.py`; it runs on the
first CUDA card unless `RAGDPO_DEVICE=cpu`.
"""

from __future__ import annotations

import json
import pathlib
import sys

if __package__ in (None, ""):  # `streamlit run .../streamlit_app.py`
    # executes this file as a top-level script with no package context:
    # bootstrap the repo root so the absolute imports below resolve
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

NATURES = [None, "DOCTRINE", "GUIDE", "SANCTION", "TECHNIQUE", "MIXTE"]
DEPTHS = [5, 8, 12]


def _require_streamlit():
    try:
        import streamlit as st  # noqa: F401

        return st
    except ImportError as e:  # pragma: no cover
        raise SystemExit(
            "streamlit n'est pas installé — utilisez le CLI:\n"
            "  python -m rag_dpo_tpu_torch.app.cli chat"
        ) from e


def build_system(device=None):
    """Assemble both pipelines + logging once (st.cache_resource target,
    mirroring the reference's init_rag_system, app.py:42-124).

    Production stack when a saved index checkpoint exists (config-
    driven bootstrap — same selection rule as the CLI and HTTP server);
    demo stack otherwise. Built on `device` (default: the first CUDA
    card; `"cpu"` must be asked for)."""
    from rag_dpo_tpu_torch.ingest.enterprise import EnterpriseIngestor, \
        TagRegistry
    from rag_dpo_tpu_torch.utils import Alerter, QueryLogger, default_paths

    paths = default_paths().ensure()
    from rag_dpo_tpu_torch.bootstrap import try_build_stack

    stack = try_build_stack(paths, device=device)
    if stack is not None:
        native, agent = stack.pipeline, stack.agent
        index, embedder = stack.index, stack.embedder
        bm25_stats, llm = stack.bm25_stats, stack.llm
        qlog, alerter = stack.query_logger, stack.alerter
    else:
        from rag_dpo_tpu_torch.app.demo import build_demo_stack

        native, ctx = build_demo_stack(agent=False, device=device)
        agent, _ = build_demo_stack(llm=ctx["llm"], agent=True,
                                    device=device)
        index, embedder = ctx["index"], ctx["embedder"]
        bm25_stats, llm = ctx["bm25_stats"], ctx["llm"]
        qlog = QueryLogger(paths.queries_log, paths.feedback_log)
        alerter = Alerter(qlog, paths.alerts_log)
    tags = TagRegistry(paths.root / "configs" / "enterprise_tags.json")
    ingestor = EnterpriseIngestor(index, embedder, bm25_stats, tags)
    return {
        "native": native, "agent": agent, "qlog": qlog,
        "alerter": alerter,
        "tags": tags, "ingestor": ingestor, "index": index,
        "llm": llm,
    }


# ----------------------------------------------------------------- chat

def _origin_badge(source: dict) -> str:
    meta_url = str(source.get("url", ""))
    if meta_url.startswith("enterprise://") or \
            source.get("source") == "ENTERPRISE":
        return "🏢 ENTREPRISE"
    return "🏛️ CNIL"


def render_source_cards(st, sources: list[dict]):
    """Source cards with origin badges (reference Chat page :63-110)."""
    for src in sources:
        badge = _origin_badge(src)
        title = src.get("title") or src.get("url") or f"Source {src['n']}"
        with st.expander(f"[{src['n']}] {badge} — {title}"):
            if src.get("url"):
                st.caption(src["url"])
            for cid in src.get("chunk_ids", []):
                st.caption(f"chunk: {cid}")


def render_chat(st, system):
    use_agent = st.sidebar.toggle("Pipeline agent", value=True)
    nature = st.sidebar.selectbox("Filtrer par nature", NATURES)
    tag_options = list(system["tags"].tags)
    selected_tags = st.sidebar.multiselect(
        "Documents d'entreprise (tags)", tag_options)
    depth = st.sidebar.select_slider(
        "Profondeur de recherche", DEPTHS, value=5)

    if "history" not in st.session_state:
        st.session_state["history"] = []
    for turn in st.session_state["history"]:
        st.chat_message(turn["role"]).write(turn["content"])

    q = st.chat_input("Votre question RGPD…")
    resp = None
    if q:
        st.chat_message("user").write(q)
        pipe = system["agent"] if use_agent else system["native"]
        kwargs = dict(
            where_filter={"nature": nature} if nature else None,
            enterprise_tags=selected_tags or None,
            conversation_history=st.session_state["history"],
            n_documents=depth,
        )
        box = st.chat_message("assistant")
        if hasattr(pipe, "query_stream") and hasattr(box, "empty"):
            # stream the draft, then replace it with the post-processed
            # final answer (citation renumbering happens stream-end; the
            # reference chat blocks the whole ~39 s instead,
            # `pages/1_💬_Chat.py:312`)
            slot = box.empty()
            draft = ""
            for ev, val in pipe.query_stream(q, **kwargs):
                if ev == "delta":
                    draft += val
                    slot.write(draft + " ▌")
                elif ev == "reset":
                    draft = ""
                    slot.write("*(nouvelle tentative…)*")
                elif ev == "response":
                    resp = val
            slot.write(resp.answer)
        else:
            resp = pipe.query(q, **kwargs)
            box.write(resp.answer)

        # composite-question expander (reference :255-262, 345-350)
        subs = (resp.extras or {}).get("sub_questions") or []
        if len(subs) > 1:
            with st.expander(
                    f"Question composite — {len(subs)} sous-questions"):
                for i, sub in enumerate(subs, 1):
                    st.write(f"{i}. {sub}")

        if resp.sources:
            st.subheader("Sources")
            render_source_cards(st, resp.sources)

        st.session_state["last_qid"] = system["qlog"].log_query(
            resp, pipeline="agent" if use_agent else "native")
        st.session_state["history"] = (
            st.session_state["history"]
            + [{"role": "user", "content": q},
               {"role": "assistant", "content": resp.answer}]
        )[-10:]  # last 5 turns (reference keeps a bounded history)

    # feedback buttons live OUTSIDE the new-input branch: a button click
    # triggers a streamlit rerun in which chat_input is None, so buttons
    # gated behind it could never register (the qid persists in
    # session_state and keys the widgets to the answer being rated)
    qid = st.session_state.get("last_qid")
    if qid:
        col_up, col_down = st.columns(2)
        if col_up.button("👍 Utile", key=f"up_{qid}"):
            system["qlog"].log_feedback(qid, 1)
            st.toast("Merci pour votre retour !")
        if col_down.button("👎 À améliorer", key=f"down_{qid}"):
            system["qlog"].log_feedback(qid, -1)
            st.toast("Retour enregistré.")
    return resp


# ------------------------------------------------------------ dashboard

def render_dashboard(st, system):
    hours = st.slider("Fenêtre (heures)", 1, 720, 24)
    window_s = hours * 3600
    stats = system["qlog"].get_stats(window_s)
    cols = st.columns(4)
    cols[0].metric("Requêtes", stats.get("n_queries", 0))
    cols[1].metric("Taux d'erreur",
                   f"{100 * stats.get('error_rate', 0):.0f}%")
    cols[2].metric("Taux de citation",
                   f"{100 * stats.get('citation_rate', 0):.0f}%")
    cols[3].metric("Satisfaction",
                   f"{100 * (stats.get('satisfaction') or 0):.0f}%")

    st.subheader("Requêtes récentes")
    st.table(system["qlog"].recent_queries(window_s)[-20:])
    st.subheader("Retours récents")
    st.table(system["qlog"].recent_feedback(window_s)[-20:])

    if st.button("Vérifier les alertes"):
        alerts = system["alerter"].check_and_alert()
        for a in alerts:
            st.warning(a["message"])
        if not alerts:
            st.success("Aucune alerte.")
    st.download_button(
        "Exporter JSON", data=json.dumps(stats, ensure_ascii=False),
        file_name="stats.json")

    # système: device inventory + index + micro-batcher (the same data
    # the HTTP /stats endpoint reports; reference Dashboard has no
    # system view at all — capability superset)
    st.subheader("Système")
    import torch

    sys_cols = st.columns(3)
    devices = [torch.cuda.get_device_name(i)
               for i in range(torch.cuda.device_count())]
    sys_cols[0].metric("Puces", len(devices))
    index = system.get("index")
    sys_cols[1].metric("Extraits indexés",
                       len(index) if index is not None else 0)
    search = system.get("search")
    if search is not None and hasattr(search, "batcher"):
        bs = search.batcher.stats
        sys_cols[2].metric(
            "Batch moyen (recherche)", f"{bs.mean_batch:.1f}")
        st.caption(
            f"micro-batcher : {bs.n_requests} requêtes → "
            f"{bs.n_device_calls} appels device "
            f"(max batch {bs.max_batch_seen})")
    else:
        sys_cols[2].metric("Batch moyen (recherche)", "—")
    driver = getattr(system.get("llm"), "_driver", None)
    if driver is not None:
        eng = driver.engine
        wait_ms = eng.stats["queue_wait_ns"] / 1e6 \
            / max(eng.stats["admitted"], 1)
        st.caption(
            f"pool de décodage : {eng.stats['admitted']} requêtes / "
            f"{eng.slots} slots (occupation moyenne {eng.occupancy:.1f})"
            f" · {eng.stats['tokens']} tokens"
            f" · attente moyenne {wait_ms:.0f} ms · device : préremplissage "
            f"{eng.stats['prefill_device_ns'] / 1e9:.1f} s, décodage "
            f"{eng.stats['decode_device_ns'] / 1e9:.1f} s"
            + (f" · préfixe : {eng.stats['prefix_hits']} hits, "
               f"{eng.stats['prefix_saved_tokens']} tokens évités"
               if eng.prefix_cache else "")
            + (f" · spéculation : {eng.stats['spec_dispatches']} spec / "
               f"{eng.stats['plain_dispatches']} plain"
               if eng.speculative else "")
            + (f" · {eng.stats['cancelled']} annulées"
               f" ({driver.timeouts} délais expirés)"
               if eng.stats.get("cancelled") else "")
            + (f" · {eng.stats['preempted']} préemptées"
               if eng.stats.get("preempted") else ""))
    from ..serving.batcher import find_choose_batcher

    cb = find_choose_batcher(system)
    if cb is not None:
        st.caption(
            f"choix contraints : {cb.stats.n_requests} requêtes → "
            f"{cb.stats.n_device_calls} appels device "
            f"(batch moyen {cb.stats.mean_batch:.1f})")
    st.caption("devices : " + (", ".join(devices) or "cpu"))
    return stats


# ------------------------------------------------------------ documents

def render_documents(st, system):
    ingestor = system["ingestor"]

    st.subheader("Ajouter un document")
    upload = st.file_uploader(
        "Document interne (pdf, docx, xlsx, odt, ods, html, txt)",
        type=["pdf", "docx", "xlsx", "odt", "ods", "html", "txt", "md"])
    existing = list(system["tags"].tags)
    chosen = st.multiselect("Tags existants", existing)
    new_tag = st.text_input("Nouveau tag (optionnel)")
    result = None
    if upload is not None and st.button("Indexer"):
        import pathlib
        import tempfile

        tags = chosen + ([new_tag] if new_tag else [])
        tmp = pathlib.Path(tempfile.mkdtemp()) / upload.name
        tmp.write_bytes(upload.getvalue())
        try:
            result = ingestor.ingest(tmp, tags=tags)
        except ValueError as e:
            # corrupt/unsupported upload: parser contract raises
            # ValueError — show it instead of crashing the page
            st.error(f"Fichier illisible : {e}")
        else:
            st.success(
                f"{result['n_chunks']} extraits indexés "
                f"({result['doc_id']}, tags: {', '.join(result['tags'])})")

    st.subheader("Documents indexés")
    docs = ingestor.list_documents()
    if docs:
        st.table(docs)
    else:
        st.caption("Aucun document d'entreprise indexé.")
    target = st.selectbox(
        "Supprimer un document",
        [None] + [d["doc_id"] for d in docs])
    if target and st.button("Purger"):
        n = ingestor.purge(target)
        st.success(f"{n} extraits supprimés.")
    return result or docs


# ----------------------------------------------------------------- main

def render_about(st, system):
    """À-propos page: project, stack table, version (reference
    `pages/4_ℹ️_À_propos.py` — content independently authored for the
    TPU stack)."""
    from rag_dpo_tpu_torch import __version__

    st.markdown(
        "### À propos\n\n"
        "**RAG-DPO TPU** — assistant RGPD/CNIL pour délégués à la "
        "protection des données, reconstruit comme un moteur de "
        "récupération TPU-natif : l'index vit en HBM, la recherche "
        "hybride est un programme device unique, et tout reste local "
        "(aucun appel cloud)."
    )
    st.markdown(
        "#### Pile technique\n\n"
        "| Composant | Implémentation |\n"
        "|---|---|\n"
        "| Index | matrice device-résidente shardée (dense bf16/int8 + "
        "lexical ELL/postings), top-k fusionné |\n"
        "| Encodeur | BGE-M3 en PyTorch (dense + lexical + ColBERT en "
        "une passe, flash-attention CUDA écrite pour Hopper) |\n"
        "| Re-ranking | cross-encoder PyTorch ou MaxSim ColBERT |\n"
        "| Fusion | RRF pondérée sur device (k=60) |\n"
        "| Agent | machine à états explicite (11 comportements, "
        "validation d'ancrage déterministe) |\n"
        "| Génération | LLM au choix : endpoint HTTP compatible Ollama "
        "(le décodeur servi sur la carte reste à porter) |\n"
        "| Parallélisme | une carte (le multi-GPU reste à porter) |\n"
        "| Interfaces | Streamlit, CLI, API HTTP (JSON + binaire + "
        "SSE) |\n"
    )
    index = system.get("index")
    cols = st.columns(3)
    cols[0].metric("Version", __version__)
    cols[1].metric("Extraits indexés",
                   len(index) if index is not None else 0)
    import torch

    cols[2].metric("Backend",
                   "cuda" if torch.cuda.is_available() else "cpu")
    st.caption(
        "Parité fonctionnelle avec l'assistant de référence, "
        "re-conçue TPU-first — voir PARITY.md et BENCHMARKS.md du "
        "dépôt pour la couverture et les mesures."
    )


def render_home(st, system):
    st.markdown(
        "## RAG-DPO TPU\nMoteur de recherche documentaire RGPD "
        "TPU-natif : index dense+lexical sur puce, encodeur BGE-M3 "
        "multi-représentations, agent de validation."
    )
    n_live = len(system["index"]) if system.get("index") is not None else 0
    st.metric("Extraits indexés", n_live)
    stats = system["qlog"].get_stats()
    st.metric("Requêtes (24 h)", stats.get("n_queries", 0))


def main():  # pragma: no cover — requires streamlit runtime
    import os

    # default: the first CUDA card; RAGDPO_DEVICE=cpu asks for the CPU
    device = os.environ.get("RAGDPO_DEVICE") or None
    st = _require_streamlit()
    st.set_page_config(page_title="RAG-DPO TPU", layout="wide")

    @st.cache_resource
    def _system():
        return build_system(device=device)

    system = _system()
    page = st.sidebar.radio(
        "Page", ["Accueil", "Chat", "Dashboard", "Documents", "À propos"])
    if page == "Chat":
        render_chat(st, system)
    elif page == "Dashboard":
        render_dashboard(st, system)
    elif page == "Documents":
        render_documents(st, system)
    elif page == "Accueil":
        render_home(st, system)
    else:
        render_about(st, system)


if __name__ == "__main__":  # pragma: no cover
    main()
