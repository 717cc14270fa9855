"""The control of the correctness check, on the card: each cell's
reference computed with TF32 matmuls (the nearest precision below the
configurations' fp32), put in the program's place at the served positions
and judged as the program is, must make the run come out not correct.  A
run of ten seconds at the cell's own size; the chip's proof runs it on
three seeds or more (``PERF.md``)."""
import pytest

from bench.harness import common


@pytest.mark.card
@pytest.mark.parametrize(
    "cell", [w["name"] for w in common.manifest()["workloads"]])
def test_control_is_not_correct(cell, card, capsys):
    import json
    from bench import run
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 77),
                   "--seconds", "10", "--trace", "0", "--control", "1"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with capsys.disabled():
        print(cell, "control:", json.dumps(res["check"]))
    limits = common.part("workloads", cell)["check"]["limits"]
    assert not res["correct"], res["check"]
    assert any(res["check"][name]["value"] > lim
               for name, lim in limits.items())
