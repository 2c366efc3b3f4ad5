"""The port's checkpoints (``repro_torch/ckpt/checkpoint.py``) against the
reference's contract (``tests/test_ckpt.py``): roundtrip, latest and
keep-k, atomic publish, checksum and shape errors; and the file format
shared with the reference: leaves numbered with dict keys sorted, so a
directory the reference's ``save`` wrote restores through the port's
``restore`` and the reverse, manifest and all."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.tree_util import tree_leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4))
                                  .astype(np.float32)),
            "nested": {"b": torch.arange(5.0), "s": np.int32(7)}}


def _zeros_like(tree):
    return {"w": torch.zeros(8, 4),
            "nested": {"b": torch.zeros(5), "s": np.int32(0)}}


def _equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t)
    out = ckpt.restore(tmp_path, 3, _zeros_like(t))
    assert _equal(t, out)
    assert isinstance(out["nested"]["b"], np.ndarray)


def test_restore_places_each_leaf(tmp_path):
    """``place`` holds a callable (or None) per leaf, as the reference's
    ``shardings`` tree holds a sharding per leaf."""
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    place = {"w": lambda a: torch.from_numpy(a) * 2,
             "nested": {"b": torch.from_numpy, "s": None}}
    out = ckpt.restore(tmp_path, 1, _zeros_like(t), place=place)
    assert torch.equal(out["w"], t["w"] * 2)
    assert torch.equal(out["nested"]["b"], t["nested"]["b"])
    assert out["nested"]["s"] == 7 and isinstance(out["nested"]["s"],
                                                  np.ndarray)


def test_latest_and_keep_k(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(d.name for d in Path(tmp_path).glob("step_*"))
    assert len(kept) == 2 and kept[-1].endswith("00000005")
    assert ckpt.latest_step(tmp_path / "empty") is None


def test_atomic_no_tmp_left(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    assert not list(Path(tmp_path).glob("*.tmp"))


def test_checksum_verification(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    f = next(Path(tmp_path).glob("step_*/arr_00000.npy"))
    arr = np.load(f)
    arr.flat[0] += 1
    np.save(f, arr)
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, 1, _zeros_like(_tree()))


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    bad = _zeros_like(_tree())
    bad["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, 1, bad)


def test_dict_leaves_in_sorted_key_order(tmp_path):
    """The Boussinesq state ``{"u0", "u1", "u2", "b"}`` is written
    ``b, u0, u1, u2``, as ``jax.tree_util`` numbers it (insertion order
    would be another file format), and the manifest's treedef and
    leaves are the reference's for the same tree."""
    state = {k: (np.full((2, 3), i, np.float32),
                 np.full((2, 3), 10 + i, np.float32))
             for i, k in enumerate(("u0", "u1", "u2", "b"))}
    tree = {"state": state, "t": np.float64(0.5), "step": np.int64(4)}
    ckpt.save(tmp_path / "port", 4, tree)
    ref_ckpt.save(tmp_path / "ref", 4, tree)
    src = tmp_path / "port" / "step_00000004"
    firsts = [float(np.load(src / f"arr_{i:05d}.npy").flat[0])
              for i in range(8)]
    assert firsts == [3, 13, 0, 10, 1, 11, 2, 12]     # b, u0, u1, u2
    port = json.loads((src / "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_00000004" /
                      "manifest.json").read_text())
    assert port == ref


def test_reference_written_checkpoint_restores_in_the_port(tmp_path):
    """A directory the reference's ``save`` wrote (jax arrays, nested
    dicts, a tuple) restores through the port's ``restore`` with equal
    arrays, checksums verified."""
    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "z": rng.standard_normal(7).astype(np.float32),
              "m": rng.integers(0, 9, (3, 2)).astype(np.int32)}
    ref_tree = {"params": {"z": jnp.asarray(arrays["z"]),
                           "a": jnp.asarray(arrays["a"])},
                "pair": (jnp.asarray(arrays["m"]), jnp.asarray(arrays["z"])),
                "step": np.int64(9)}
    ref_ckpt.save(tmp_path, 9, ref_tree)
    target = {"params": {"z": torch.zeros(7), "a": torch.zeros(6, 5)},
              "pair": (torch.zeros(3, 2), torch.zeros(7)),
              "step": np.int64(0)}
    out = ckpt.restore(tmp_path, ckpt.latest_step(tmp_path), target,
                       place={"params": {"z": torch.from_numpy,
                                         "a": torch.from_numpy},
                              "pair": (torch.from_numpy, None),
                              "step": None})
    assert torch.equal(out["params"]["a"], torch.from_numpy(arrays["a"]))
    assert torch.equal(out["params"]["z"], torch.from_numpy(arrays["z"]))
    np.testing.assert_array_equal(out["pair"][0], arrays["m"])
    np.testing.assert_array_equal(out["pair"][1], arrays["z"])
    assert int(out["step"]) == 9
