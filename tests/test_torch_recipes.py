"""The port's recipes (cyclonus_tpu_torch/recipes) against the
reference's: the same 15 scenarios, and for each one the explain table,
the resources table and the probe's result, ingress and egress tables of
the port's cuda engine (on the CPU) and oracle equal to the reference's
oracle tables; the `recipes` command prints the reference's report."""

import io

import pytest

from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.matcher import explain_table as ref_explain
from cyclonus_tpu.recipes import ALL_RECIPES as REF_RECIPES
from cyclonus_tpu.recipes import run_all_recipes as ref_run_all
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.matcher import build_network_policies, explain_table
from cyclonus_tpu_torch.recipes import ALL_RECIPES, run_all_recipes

NAMES = [r.name for r in REF_RECIPES]


def test_the_same_fifteen_recipes():
    assert [r.name for r in ALL_RECIPES] == NAMES and len(NAMES) == 15
    for mine, ref in zip(ALL_RECIPES, REF_RECIPES):
        assert (mine.protocol, mine.port, mine.policy_yamls) == (ref.protocol, ref.port,
                                                                ref.policy_yamls)
        assert mine.resources.render_table() == ref.resources.render_table()


def tables(table):
    return table.render_table(), table.render_ingress(), table.render_egress()


@pytest.mark.parametrize("index", range(15), ids=NAMES)
def test_recipe_tables_equal_reference(index):
    mine, ref = ALL_RECIPES[index], REF_RECIPES[index]
    want = tables(ref.run_probe(engine="oracle"))
    policy = build_network_policies(True, mine.policies())
    assert explain_table(policy) == ref_explain(ref_build(True, ref.policies()))
    assert tables(mine.run_probe(engine="cuda", policy=policy, device="cpu")) == want
    assert tables(mine.run_probe(engine="oracle", policy=policy)) == want


@pytest.mark.parametrize("engine", ["oracle", "cuda"])
def test_run_all_prints_the_reference_report(engine, capsys):
    want = io.StringIO()
    ref_run_all(engine="oracle", out=want)
    got = io.StringIO()
    run_all_recipes(engine=engine, out=got, device="cpu")
    assert got.getvalue() == want.getvalue()
    argv = ["recipes", "--engine", engine] + (["--device", "cpu"] if engine == "cuda" else [])
    assert main(argv) == 0
    assert capsys.readouterr().out == want.getvalue()


def test_cuda_engine_needs_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["recipes"])
