"""Text queries from scene object metadata.

Copy of ``dropclip_tpu/data/queries.py``:

- ``prepare_queries`` (the dataset side, reference
  data/dataset_blender.py:172-255) builds the evaluation queries of one of
  five scenarios, telling duplicate classes apart by the first attribute
  unique to the object (priority brand > color > state > material,
  ``find_unique_attribute``);
- ``prepare_fusion_queries`` (the ingest side, reference
  tools/preprocess_data.py:115-149): every object gets at least one text,
  attributes come from ``concepts``, and the ingest tool prepends
  ``{0: ['table']}`` before embedding and mean-pooling each object's
  texts.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

SCENARIOS = ("cls", "cls+attr", "ambiguous", "affordance", "open")


def _attrs(obj: Dict) -> Dict[str, List[str]]:
    q = obj.get("queries", {})
    return {
        "brand": q.get("Brand"),
        "color": q.get("Color", []),
        "state": q.get("State", []),
        "material": q.get("Material", []),
    }


def find_unique_attribute(obj_info: Dict):
    """Split objects into unique/non-unique classes; pick a disambiguating
    attribute per duplicate (reference dataset_blender.py:187-224).

    Non-dict entries are dropped: the raw scene dict maps id 0 to the
    bare string 'table' (reference data/blender.py:258) and the reference
    would crash on it here."""
    obj_info = {k: v for k, v in obj_info.items() if isinstance(v, dict)}
    cls_cnt = Counter(x["cls_name"] for x in obj_info.values())
    unique_objs = {k: v for k, v in obj_info.items()
                   if cls_cnt[v["cls_name"]] == 1}
    non_unique = {k: v for k, v in obj_info.items() if k not in unique_objs}

    by_cls: Dict[str, List] = {}
    for obj_id, data in non_unique.items():
        by_cls.setdefault(data["cls_name"], []).append((obj_id, data))

    unique_attributes: Dict = {}
    for _, obj_list in by_cls.items():
        obj_attrs = {obj_id: _attrs(data) for obj_id, data in obj_list}
        for obj_id, attrs in obj_attrs.items():
            if attrs["brand"]:
                chosen: Optional[str] = attrs["brand"]
            else:
                chosen = None
                for key in ("color", "state", "material"):
                    for value in attrs[key]:
                        if all(value not in other[key]
                               for oid, other in obj_attrs.items()
                               if oid != obj_id):
                            chosen = value
                            break
                    if chosen:
                        break
            unique_attributes[obj_id] = chosen
    return unique_objs, non_unique, unique_attributes


def prepare_queries(obj_info: Dict, scenario: str = "cls") -> Dict[int, List[str]]:
    """object id -> list of query strings for the given eval scenario
    (reference dataset_blender.py:228-255)."""
    unique_objs, _, unique_attributes = find_unique_attribute(obj_info)

    if scenario == "cls":
        return {k: [v["cls_name"]] for k, v in unique_objs.items() if k > 0}
    if scenario == "cls+attr":
        names = {k: [v["cls_name"]] for k, v in unique_objs.items() if k > 0}
        amb = {k: [v] for k, v in unique_attributes.items()
               if v is not None and k > 0}
        return {**names, **amb}
    if scenario == "ambiguous":
        return {k: [v] for k, v in unique_attributes.items()
                if v is not None and k > 0}
    if scenario == "affordance":
        return {k: v["queries"]["Affordance"] for k, v in unique_objs.items()
                if "Affordance" in v.get("queries", {})}
    if scenario == "open":
        out = {k: list(v["queries"]["More descriptions"])
               for k, v in unique_objs.items()
               if "More descriptions" in v.get("queries", {})}
        for k in out:
            if unique_objs[k]["cls_name"] not in out[k]:
                out[k].append(unique_objs[k]["cls_name"])
        return out
    raise ValueError(f"Unknown eval scenario {scenario!r}")


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
