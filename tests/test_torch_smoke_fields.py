"""``chip_smoke.py``'s shared seeded fields, on the CPU at a small grid: the
fields read back from the files ``make_shared_fields`` writes are the
ones ``radiating_field`` makes, bit for bit, through the adaptor the
chains use; a call the files do not cover makes its field as before; the
function is restored on leaving."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.core.insitu import adaptors  # noqa: E402


def test_shared_fields_read_back_bit_for_bit(tmp_path, monkeypatch):
    dims = (48, 40)
    monkeypatch.setattr(chip_smoke, "FIELD_CACHE", tmp_path / "fields")
    monkeypatch.setattr(chip_smoke, "SHARED_FIELDS",
                        tuple((dims, s) for s in range(3)))
    chip_smoke.make_shared_fields()
    assert len(list((tmp_path / "fields").glob("*.npy"))) == 6
    made = adaptors.radiating_field
    calls = []
    monkeypatch.setattr(adaptors, "radiating_field",
                        lambda *a, **k: calls.append(a) or made(*a, **k))
    with chip_smoke.shared_fields():
        src = adaptors.RadiatingSourceAdaptor(dims, device="cpu")
        for step in range(3):
            got = src.produce(step)
            noisy, clean = made(dims, seed=step)
            assert np.array_equal(got.arrays["field"].numpy(), noisy)
            assert np.array_equal(got.arrays["clean_reference"].numpy(),
                                  clean)
        assert not calls                    # read, not made
        other = adaptors.radiating_field(dims, seed=5)
        assert np.array_equal(other[0], made(dims, seed=5)[0])
        adaptors.radiating_field(dims, seed=1, noise_frac=0.25)
        assert len(calls) == 2              # made: not in the files
    assert adaptors.radiating_field is not made   # the test's wrapper back
