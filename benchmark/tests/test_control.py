"""The control of ``correct``: the reference computed one precision below
the mix's (bfloat16 for float32, float32 for float64) and put in the
program's place must fail the mix's limits, on every seed, while the
program's own results pass them. At tiny sizes on the CPU here; on the
card at the cells' sizes by ``benchmark/control.py`` (PERF.md)."""

import pytest

from benchlib import reference, spec
from conftest import BENCH, tiny_root


@pytest.mark.parametrize("mix", ["f32-stream", "f32-sync", "f64-stream"])
@pytest.mark.parametrize("config", ["tiny_graph", "tiny_mesh"])
def test_the_control_fails_and_the_program_passes(tmp_path, config, mix):
    import control
    root = tiny_root(tmp_path)
    limits = spec.load_json(BENCH / "traffic" / f"{mix}.json")["limits"]
    rows = control.readings(f"{config}.{mix}", [1, 2**31 + 3, 77],
                            program=True, device="cpu", root=root)
    for _, row in rows:
        assert reference.judge(row["program"], limits), row
        assert not reference.judge(row["control"], limits), row
        # the control fails by its values, not by its pattern
        assert row["control"]["pattern_gap"] == 0
        assert row["control"]["max_rel_err"] > 10 * limits["max_rel_err"]
