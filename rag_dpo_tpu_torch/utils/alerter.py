"""Threshold alerting on query-log statistics.

Role parity with `src/utils/alerter.py`: thresholds on error rate (>20%),
average latency (>60 s), satisfaction (<50%) and zero-citation rate (>30%)
(`configs/config.yaml:95-99`); alerts append to `alerts.jsonl` and may be
emailed via SMTP (:98-269). SMTP stays optional/off by default.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

from .query_logger import QueryLogger


@dataclasses.dataclass
class AlertConfig:
    error_rate: float = 0.20
    avg_time_s: float = 60.0
    satisfaction: float = 0.50
    zero_citation_rate: float = 0.30
    window_s: float = 86_400
    smtp_enabled: bool = False
    smtp_host: str = ""
    smtp_port: int = 587
    smtp_user: str = ""
    smtp_password: str = ""
    smtp_to: str = ""


class Alerter:
    def __init__(self, query_logger: QueryLogger, alerts_path,
                 config: AlertConfig | None = None):
        self.query_logger = query_logger
        self.alerts_path = pathlib.Path(alerts_path)
        self.config = config or AlertConfig()

    def check(self) -> list[dict]:
        cfg = self.config
        stats = self.query_logger.get_stats(cfg.window_s)
        alerts: list[dict] = []
        if stats.get("n_queries", 0) == 0:
            return alerts

        def add(kind: str, value, threshold, message: str):
            alerts.append({
                "ts": time.time(), "kind": kind, "value": value,
                "threshold": threshold, "message": message,
            })

        if stats["error_rate"] > cfg.error_rate:
            add("error_rate", round(stats["error_rate"], 3),
                cfg.error_rate,
                f"taux d'erreur {stats['error_rate']:.0%} au-dessus du "
                f"seuil {cfg.error_rate:.0%}")
        if stats["avg_total_time"] > cfg.avg_time_s:
            add("avg_time", round(stats["avg_total_time"], 1),
                cfg.avg_time_s,
                f"latence moyenne {stats['avg_total_time']:.1f}s au-dessus "
                f"de {cfg.avg_time_s:.0f}s")
        sat = stats.get("satisfaction")
        if sat is not None and sat < cfg.satisfaction:
            add("satisfaction", round(sat, 3), cfg.satisfaction,
                f"satisfaction {sat:.0%} sous le seuil "
                f"{cfg.satisfaction:.0%}")
        if stats["zero_citation_rate"] > cfg.zero_citation_rate:
            add("zero_citation", round(stats["zero_citation_rate"], 3),
                cfg.zero_citation_rate,
                f"{stats['zero_citation_rate']:.0%} de réponses sans "
                f"citation")
        return alerts

    def check_and_alert(self) -> list[dict]:
        alerts = self.check()
        if alerts:
            self.alerts_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.alerts_path, "a", encoding="utf-8") as f:
                for a in alerts:
                    f.write(json.dumps(a, ensure_ascii=False) + "\n")
            if self.config.smtp_enabled:
                self._send_email(alerts)
        return alerts

    def _send_email(self, alerts: list[dict]):
        import smtplib
        from email.message import EmailMessage

        cfg = self.config
        msg = EmailMessage()
        msg["Subject"] = f"[rag-dpo-tpu] {len(alerts)} alerte(s)"
        msg["From"] = cfg.smtp_user or "rag-dpo-tpu@localhost"
        msg["To"] = cfg.smtp_to
        msg.set_content("\n".join(a["message"] for a in alerts))
        try:
            with smtplib.SMTP(cfg.smtp_host, cfg.smtp_port,
                              timeout=10) as smtp:
                smtp.starttls()
                if cfg.smtp_user:
                    smtp.login(cfg.smtp_user, cfg.smtp_password)
                smtp.send_message(msg)
        except Exception:
            pass  # alerting must never take the app down
