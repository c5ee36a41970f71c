"""portbench: the end-to-end benchmark of `rag_dpo_tpu_torch` on one card.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json`. Everything a
cell needs is found by name: its configuration (`configs/<name>.json`,
which names the system adapter in `systems/`), its traffic mix
(`traffic/<name>.json`, read by the one generator in `traffic.py`) and
each per-layer metric (`metrics/<name>.py`). The plain references that
decide `correct` live in `reference/` and import nothing of the port.
"""
