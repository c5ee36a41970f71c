"""GDPR/CNIL acronym expansion (host-side query preprocessing).

Role parity with the reference's acronym dictionary + inline expansion
(`src/utils/acronyms.py:6-198`): queries containing known acronyms get the
expanded form appended so both dense and lexical arms can match documents
that spell terms out. The dictionary below is standard French
data-protection vocabulary (independent compilation).
"""

from __future__ import annotations

import re

ACRONYMS: dict[str, str] = {
    "rgpd": "règlement général sur la protection des données",
    "gdpr": "règlement général sur la protection des données",
    "cnil": "commission nationale de l'informatique et des libertés",
    "dpo": "délégué à la protection des données",
    "dpd": "délégué à la protection des données",
    "aipd": "analyse d'impact relative à la protection des données",
    "pia": "analyse d'impact relative à la protection des données",
    "dpia": "analyse d'impact relative à la protection des données",
    "bcr": "règles d'entreprise contraignantes",
    "cct": "clauses contractuelles types",
    "scc": "clauses contractuelles types",
    "cepd": "comité européen de la protection des données",
    "edpb": "comité européen de la protection des données",
    "edps": "contrôleur européen de la protection des données",
    "dcp": "données à caractère personnel",
    "rt": "responsable de traitement",
    "st": "sous-traitant",
    "dsi": "direction des systèmes d'information",
    "rssi": "responsable de la sécurité des systèmes d'information",
    "ssi": "sécurité des systèmes d'information",
    "pssi": "politique de sécurité des systèmes d'information",
    "anssi": "agence nationale de la sécurité des systèmes d'information",
    "nis": "directive sur la sécurité des réseaux et des systèmes d'information",
    "nis2": "directive sur la sécurité des réseaux et des systèmes d'information",
    "lil": "loi informatique et libertés",
    "cada": "commission d'accès aux documents administratifs",
    "cjue": "cour de justice de l'union européenne",
    "dma": "règlement sur les marchés numériques",
    "dsa": "règlement sur les services numériques",
    "ia": "intelligence artificielle",
    "rh": "ressources humaines",
    "sirh": "système d'information de gestion des ressources humaines",
    "crm": "gestion de la relation client",
    "erp": "progiciel de gestion intégré",
    "vpn": "réseau privé virtuel",
    "api": "interface de programmation",
    "sso": "authentification unique",
    "mfa": "authentification multifacteur",
    "2fa": "authentification à deux facteurs",
    "dlp": "prévention des fuites de données",
    "siem": "gestion des informations et des événements de sécurité",
    "edr": "détection et réponse sur les terminaux",
    "saas": "logiciel en tant que service",
    "paas": "plateforme en tant que service",
    "iaas": "infrastructure en tant que service",
    "cloud": "informatique en nuage",
    "cookies": "traceurs de navigation",
    "opt-in": "consentement préalable",
    "opt-out": "droit d'opposition",
    "kyc": "connaissance client",
    "lcb-ft": "lutte contre le blanchiment et le financement du terrorisme",
    "hds": "hébergeur de données de santé",
    "ehpad": "établissement d'hébergement pour personnes âgées dépendantes",
    "cse": "comité social et économique",
    "ccas": "centre communal d'action sociale",
    "ars": "agence régionale de santé",
    "cpam": "caisse primaire d'assurance maladie",
    "urssaf": "union de recouvrement des cotisations de sécurité sociale",
    "insee": "institut national de la statistique",
    "nir": "numéro d'inscription au répertoire national",
    "rcp": "registre des activités de traitement",
    "ropa": "registre des activités de traitement",
    "dsp2": "directive sur les services de paiement",
    "pca": "plan de continuité d'activité",
    "pra": "plan de reprise d'activité",
    "tia": "évaluation des transferts internationaux",
    "dtia": "évaluation des transferts internationaux de données",
    # institutions / textes  (nota: pas d'entrée « ce » — collision avec
    # le déterminant français)
    "cnam": "caisse nationale de l'assurance maladie",
    "cnaf": "caisse nationale des allocations familiales",
    "dgccrf": "direction générale de la concurrence, de la consommation "
              "et de la répression des fraudes",
    "arcep": "autorité de régulation des communications électroniques",
    "arcom": "autorité de régulation de la communication audiovisuelle "
             "et numérique",
    "hatvp": "haute autorité pour la transparence de la vie publique",
    "has": "haute autorité de santé",
    "ans": "agence du numérique en santé",
    "ico": "autorité britannique de protection des données",
    "aepd": "autorité espagnole de protection des données",
    "g29": "groupe de travail article 29",
    "wp29": "groupe de travail article 29",
    "eprivacy": "directive vie privée et communications électroniques",
    "lcen": "loi pour la confiance dans l'économie numérique",
    "lpm": "loi de programmation militaire",
    "sren": "loi visant à sécuriser et réguler l'espace numérique",
    "dga": "règlement sur la gouvernance des données",
    "data act": "règlement sur les données",
    "ai act": "règlement sur l'intelligence artificielle",
    "dora": "règlement sur la résilience opérationnelle numérique",
    "psd2": "directive sur les services de paiement",
    # santé / social
    "snds": "système national des données de santé",
    "dmp": "dossier médical partagé",
    "pmsi": "programme de médicalisation des systèmes d'information",
    "cpp": "comité de protection des personnes",
    "cnrips": "référentiels de sécurité des données de santé",
    "mdph": "maison départementale des personnes handicapées",
    "esms": "établissements et services sociaux et médico-sociaux",
    # sécurité / technique
    "ids": "système de détection d'intrusion",
    "ips": "système de prévention d'intrusion",
    "waf": "pare-feu applicatif",
    "soc": "centre opérationnel de sécurité",
    "csirt": "équipe de réponse aux incidents de sécurité",
    "cert": "centre d'alerte et de réaction aux attaques informatiques",
    "pki": "infrastructure de gestion de clés",
    "hsm": "module matériel de sécurité",
    "tls": "protocole de chiffrement des communications",
    "ssl": "protocole de chiffrement des communications",
    "https": "protocole web sécurisé",
    "sftp": "protocole de transfert de fichiers sécurisé",
    "ad": "annuaire d'entreprise active directory",
    "ldap": "annuaire d'entreprise",
    "iam": "gestion des identités et des accès",
    "pam": "gestion des accès à privilèges",
    "byod": "utilisation d'équipements personnels au travail",
    "mdm": "gestion des terminaux mobiles",
    "ocr": "reconnaissance optique de caractères",
    "rfid": "identification par radiofréquence",
    "iot": "objets connectés",
    "gps": "géolocalisation par satellite",
    "ip": "adresse de protocole internet",
    "mac": "adresse matérielle réseau",
    "dns": "système de noms de domaine",
    "cdn": "réseau de diffusion de contenu",
    "cms": "système de gestion de contenu",
    "etl": "extraction, transformation et chargement de données",
    "bi": "informatique décisionnelle",
    "ml": "apprentissage automatique",
    "llm": "grand modèle de langage",
    "nlp": "traitement automatique du langage",
    # métier / conformité
    "cgu": "conditions générales d'utilisation",
    "cgv": "conditions générales de vente",
    "dpa": "accord de traitement des données",
    "nda": "accord de confidentialité",
    "sla": "accord de niveau de service",
    "rfp": "appel d'offres",
    "poc": "preuve de concept",
    "mssi": "mesures de sécurité des systèmes d'information",
    "ebios": "méthode d'analyse de risques de l'anssi",
    "iso 27001": "norme de management de la sécurité de l'information",
    "iso 27701": "norme de management de la protection de la vie privée",
    "secnumcloud": "qualification de sécurité cloud de l'anssi",
    "violation": "violation de données à caractère personnel",
    "pseudonymisation": "traitement rendant les données non directement "
                        "identifiantes",
    "dcn": "données de connexion",
    "teletravail": "travail à distance",
    "whistleblowing": "dispositif d'alerte professionnelle",
    "cil": "correspondant informatique et libertés",
    "privacy by design": "protection des données dès la conception",
    "privacy by default": "protection des données par défaut",
    "accountability": "principe de responsabilité démontrable",
    "profilage": "traitement automatisé d'évaluation de personnes",
}

_METHOD_HINTS = {
    "aipd": "méthodologie analyse d'impact étapes",
    "pia": "méthodologie analyse d'impact étapes",
    "dpia": "méthodologie analyse d'impact étapes",
}


def expand_acronyms(query: str) -> str:
    """Append expansions for acronyms present in the query (word-boundary
    match, case-insensitive). Methodology acronyms additionally pull in
    process keywords (the reference enriches AIPD queries the same way)."""
    additions: list[str] = []
    low = query.lower()
    for acro, full in ACRONYMS.items():
        if re.search(rf"\b{re.escape(acro)}\b", low):
            if full not in low:
                additions.append(full)
            hint = _METHOD_HINTS.get(acro)
            if hint:
                additions.append(hint)
    if not additions:
        return query
    # dedup, keep order
    seen: set[str] = set()
    uniq = [a for a in additions if not (a in seen or seen.add(a))]
    return f"{query} ({'; '.join(uniq)})"
