"""Evaluation helpers of the port. Only the synthetic corpus and the
extractive fake LLM are here so far; the hermetic replay is queued
(ROADMAP, port queue item 1)."""
