"""Text queries for ingest fusion from scene object metadata.

Copy of ``prepare_fusion_queries`` from ``dropclip_tpu/data/queries.py``
(reference tools/preprocess_data.py:115-149): every object gets at least
one text, attributes come from ``concepts``, and the ingest tool prepends
``{0: ['table']}`` before embedding and mean-pooling each object's texts.
"""

from __future__ import annotations

from typing import Dict, List

SCENARIOS = ("cls", "cls+attr", "ambiguous", "affordance", "open")


def prepare_fusion_queries(obj_info: Dict, scenario: str = "cls"
                           ) -> Dict[int, List[str]]:
    """object id -> query texts for the fusion weights of one scenario.
    Non-dict entries (the raw scene's bare 'table' string) are dropped."""
    obj_info = {k: v for k, v in obj_info.items() if isinstance(v, dict)}
    if scenario == "cls":
        return {k: [v["cls_name"]] for k, v in obj_info.items()}
    if scenario == "cls+attr":
        names = {k: [v["cls_name"]] for k, v in obj_info.items()}
        for k, v in obj_info.items():
            c = v.get("concepts")
            if c is not None:
                names[k].extend(c.get("Color", []))
                names[k].extend(c.get("Material", []))
                names[k].extend(c.get("State", []))
                brand = c.get("Brand")
                if isinstance(brand, str):
                    names[k].append(brand)
                elif isinstance(brand, list):
                    names[k].extend(brand)
        return names
    if scenario == "affordance":
        return {k: (v["concepts"]["Affordance"]
                    if v.get("concepts") and "Affordance" in v["concepts"]
                    else [v["cls_name"]])
                for k, v in obj_info.items()}
    if scenario == "open":
        out = {}
        for k, v in obj_info.items():
            c = v.get("concepts")
            texts = (list(c["More descriptions"])
                     if c is not None and "More descriptions" in c
                     else [v["cls_name"]])
            if v["cls_name"] not in texts:
                texts.append(v["cls_name"])
            out[k] = texts
        return out
    raise ValueError(f"Unknown eval scenario {scenario!r}")
