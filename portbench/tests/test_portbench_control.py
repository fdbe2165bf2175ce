"""The control, at a size the CPU holds: the reference put in the
program's place with its products' operands rounded to the
configuration's ``control_precision`` reads well above the program."""

import pytest

from portbench.harness import judge, program
from portbench.harness.program import Program
from portbench.tests import tiny

CASES = [("bert-base-mlm.terngrad.b32", "bfloat16"),
         ("bert-base-mlm.identity.b32", "bfloat16"),
         ("resnet50-gn-imagenet.eftopk.b128", "float32"),
         ("resnet50-gn-imagenet.identity.b128", "float32")]


@pytest.mark.parametrize("workload,compute", CASES)
def test_control_reads_above_the_program(workload, compute):
    cell = tiny.cell(workload, compute)
    seed = 41
    prog = Program(cell, seed, "cpu")
    mine = prog.first_steps(seed, judge.FIRST_STEPS)
    order = list(prog.shapes)
    ref = judge.reference(cell, seed, "cpu", order)
    low = judge.reference(cell, seed, "cpu", order,
                          cell.cfg["control_precision"])
    got, control = judge.gaps(mine, ref), judge.gaps(low, ref)
    assert any(control[k]["value"] >= 3 * got[k]["value"]
               and control[k]["value"] > 0 for k in got)
    assert list(program.weights(cell, seed, "cpu")) == order
