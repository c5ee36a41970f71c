"""Image classification for scraped figures (OCR gate + vision LLM).

Role parity with `src/processing/classify_images.py` (phase 4B): a
Tesseract OCR word-count gate decides cheaply — ≥20 words → SCHEMA_DPO
(text-dense diagram), <5 words → PHOTO_DECO (dropped from the manifest),
in between → LLaVA-class vision model classifies SCHEMA_DPO / INFOGRAPHIE
/ PHOTO_DECO (thresholds :45-50, prompt role :53-70).

Both the OCR dependency (pytesseract) and the vision call are optional:
without them every image defaults to INFOGRAPHIE (kept), which only
costs index noise, never data loss.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

from ..providers.base import BaseLLMProvider
from ..rag.intent import extract_json_object

CLASSES = ("SCHEMA_DPO", "INFOGRAPHIE", "PHOTO_DECO")

VISION_PROMPT = """Classe cette image issue d'un site de conformité RGPD.
Réponds STRICTEMENT en JSON : {"classe": "SCHEMA_DPO|INFOGRAPHIE|PHOTO_DECO"}
- SCHEMA_DPO : schéma ou tableau dense en texte, utile à un DPO.
- INFOGRAPHIE : visuel pédagogique avec un peu de texte.
- PHOTO_DECO : photo ou visuel purement décoratif."""


def _ocr_word_count(image_bytes: bytes) -> int | None:
    try:
        import io

        import pytesseract
        from PIL import Image

        text = pytesseract.image_to_string(
            Image.open(io.BytesIO(image_bytes)), lang="fra"
        )
        return len(text.split())
    except Exception:
        return None


@dataclasses.dataclass
class ImageDecision:
    label: str
    method: str        # ocr_gate | vision | default
    ocr_words: int | None = None

    @property
    def keep(self) -> bool:
        return self.label != "PHOTO_DECO"


class ImageClassifier:
    def __init__(self, vision_llm: BaseLLMProvider | None = None,
                 schema_words: int = 20, deco_words: int = 5):
        self.vision_llm = vision_llm
        self.schema_words = schema_words
        self.deco_words = deco_words

    def classify(self, image_bytes: bytes) -> ImageDecision:
        words = _ocr_word_count(image_bytes)
        if words is not None:
            if words >= self.schema_words:
                return ImageDecision("SCHEMA_DPO", "ocr_gate", words)
            if words < self.deco_words:
                # the cheap OCR gate drops near-textless images as deco
                # BEFORE any vision call (reference thresholds :45-50)
                return ImageDecision("PHOTO_DECO", "ocr_gate", words)
        if self.vision_llm is not None:
            resp = self.vision_llm.generate_with_image(
                VISION_PROMPT, image_bytes
            )
            if resp.ok:
                data = extract_json_object(resp.text)
                if isinstance(data, dict):
                    label = str(data.get("classe", "")).upper()
                    if label in CLASSES:
                        return ImageDecision(label, "vision", words)
        return ImageDecision("INFOGRAPHIE", "default", words)

    def classify_manifest(self, docs: list[dict], out_path=None) -> dict:
        """Classify all image docs; deco images dropped from the result."""
        kept, report = [], {}
        for doc in docs:
            if doc.get("kind") != "image":
                kept.append(doc)
                continue
            data = pathlib.Path(doc["path"]).read_bytes()
            decision = self.classify(data)
            report[doc["doc_id"]] = dataclasses.asdict(decision)
            if decision.keep:
                doc = dict(doc)
                doc["image_class"] = decision.label
                kept.append(doc)
        if out_path:
            pathlib.Path(out_path).write_text(
                json.dumps(report, ensure_ascii=False)
            )
        return {"kept": kept, "report": report}
