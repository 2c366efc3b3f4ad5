"""The port's ``launch/report.py`` against the reference's: on the same
dry-run JSON files (written here: ok and failed cells on both meshes,
every dominant term, the notes' branches) both packages' ``load``,
``dryrun_table``, ``roofline_table`` and ``summary`` return the same
strings, and ``main`` prints the same Markdown."""
import contextlib
import io
import json
import sys

from repro.launch import report as jreport
from repro_torch.launch import report


def _roofline(tc, tm, tl, coll=None, useful=0.5):
    terms = {"compute": tc, "memory": tm, "collective": tl}
    return {"t_compute_s": tc, "t_memory_s": tm, "t_collective_s": tl,
            "dominant": max(terms, key=terms.get),
            "collective_by_kind": coll or {}, "useful_ratio": useful}


CELLS = [
    ("qwen3-4b", "train_4k", "pod1", "ok",
     _roofline(0.26, 0.38, 0.41, {"all-reduce": 3.0, "total": 4.0})),
    ("qwen3-4b", "prefill_32k", "pod1", "ok", _roofline(0.1, 0.3, 0.05)),
    ("qwen3-4b", "decode_32k", "pod1", "ok", _roofline(1e-5, 0.02, 0.08)),
    ("qwen3-4b", "train_4k", "pod2", "ok", None),
    ("gemma2-27b", "decode_32k", "pod1", "ok", _roofline(1e-4, 0.03, 0.01)),
    ("mamba2-1.3b", "long_500k", "pod1", "ok", _roofline(0.9, 0.2, 0.1)),
    ("dbrx-132b", "train_4k", "pod1", "ok",
     _roofline(0.1, 0.2, 0.9, {"all-to-all": 5.0, "total": 6.0})),
    ("grok-1-314b", "prefill_32k", "pod1", "error", None),
]


def _write(tmp_path):
    for arch, shape, mesh, status, rf in CELLS:
        r = {"arch": arch, "shape": shape, "mesh": mesh,
             "chips": 512 if mesh == "pod2" else 256, "status": status,
             "compile_seconds": 12.3,
             "memory": {"total_hbm_per_chip": 3 * 2**30 + 12345},
             "raw_cost_full": {"coll": {"all-gather": 1.0,
                                        "all-reduce": 2.0, "total": 3.0}}}
        if rf is not None:
            r["roofline"] = rf
        if status == "error":
            r["error"] = "ValueError: extent 7 does not split"
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
            json.dumps(r))


def test_report_renders_the_reference_markdown(tmp_path):
    _write(tmp_path)
    cells, jcells = report.load(tmp_path), jreport.load(tmp_path)
    assert cells == jcells
    for name in ("dryrun_table", "roofline_table", "summary"):
        assert getattr(report, name)(cells) == \
            getattr(jreport, name)(jcells), name
    outs = []
    for mod in (report, jreport):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["report", str(tmp_path)]
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "| qwen3-4b | train_4k |" in outs[0]
