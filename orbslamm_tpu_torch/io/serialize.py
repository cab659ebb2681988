"""Map persistence, checkpoint and resume (port of orbslamm_tpu/io/serialize.py,
the reference's MapSerializer).

The reference saves each map as ``mapNNNNNN/map.xml`` through TinyXML
(MapSerializer.cc:60-482); here each map is one ``.npz`` of its
``MapState`` fields (keyframes with poses, calibration and descriptors,
landmarks with positions). Both packages' ``MapState`` have the same 26
fields with the same names, dtypes and shapes, so a file written by either
loads bitwise into the other. A MultiMapper session is a directory of
``map_NNNNNN.npz`` plus ``manifest.json`` (maps, keyframe counts, merges).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models import map_state as ms


def save_map(path: str | Path, m: ms.MapState) -> None:
    np.savez_compressed(path, **convert.map_state_to_numpy(m))


def load_map(path: str | Path, *, device) -> ms.MapState:
    with np.load(path) as data:
        return convert.map_state_from_numpy({k: data[k] for k in ms.MapState._fields},
                                            device=device)


def save_session(out_dir: str | Path, multimapper) -> None:
    """Save every live map of a MultiMapper and the manifest (SaveMaps)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"maps": [], "merges": list(multimapper.merges)}
    for mc in multimapper.live_maps():
        fname = f"map_{mc.map_id:06d}.npz"
        save_map(out / fname, mc.map)
        manifest["maps"].append({"file": fname, "map_id": mc.map_id, "n_kf": mc.n_kf})
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))


def load_session(out_dir: str | Path, multimapper) -> None:
    """Load the maps of ``save_session`` into a MultiMapper (LoadMaps), each
    a new ``MapContext`` on the MultiMapper's device. The vocabulary is the
    MultiMapper's (its file, or one trained from the first loaded map's
    descriptors once that map holds 4 keyframes), and every loaded
    keyframe's BoW row is computed from its descriptors."""
    from orbslamm_tpu_torch.models.system import MapContext

    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    for entry in manifest["maps"]:
        mc = MapContext(multimapper.cfg, voc=multimapper.voc, device=multimapper.device)
        mc.map = load_map(out / entry["file"], device=multimapper.device)
        mc.n_kf = entry["n_kf"]
        multimapper.maps.append(mc)
        if mc.voc is not None:
            kv = mc.map.kf_valid.cpu().numpy()
            mc.update_bow_rows([int(s) for s in np.nonzero(kv)[0]])
        elif mc.ensure_vocabulary():
            multimapper.voc = mc.voc
    multimapper.merges.extend(tuple(m) for m in manifest.get("merges", []))
