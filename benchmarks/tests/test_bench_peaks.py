"""The benchmark's copy of K3's count and the card's peaks equal
``chip_smoke.py``'s at the production shape, read from its source."""

import ast

import pytest

from benchmarks import harness, peaks, program


def _chip_smoke():
    return ast.parse((harness.ROOT / "chip_smoke.py").read_text())


def _k3_assignments(tree) -> dict:
    """The ``nb`` and ``ops`` expressions of the function that builds the
    ``sinkhorn_piT`` row."""
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        src = ast.unparse(fn)
        if 'name="sinkhorn_piT"' not in src and \
                "name='sinkhorn_piT'" not in src:
            continue
        out = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in ("nb", "ops"):
                out[node.targets[0].id] = node.value
        if set(out) == {"nb", "ops"}:
            return out
    raise AssertionError("chip_smoke.py has no K3 row with nb and ops")


def _constant(tree, name):
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == name:
            return ast.literal_eval(node.value)
    raise AssertionError(name)


@pytest.mark.parametrize("preset", ["tpu", "default"])
def test_k3_count_is_chip_smokes(preset):
    tree = _chip_smoke()
    cfg = program.config(preset, {})
    env = {"K": cfg.k_assoc, "N": cfg.n_meas, "cfg": cfg}
    ex = _k3_assignments(tree)
    nb = eval(compile(ast.Expression(ex["nb"]), "chip_smoke", "eval"), env)
    ops = eval(compile(ast.Expression(ex["ops"]), "chip_smoke", "eval"),
               env)
    assert peaks.sinkhorn_counts(cfg.k_assoc, cfg.n_meas, cfg.k_sinkhorn,
                                 4) == (nb, ops)


def test_peaks_are_chip_smokes():
    tree = _chip_smoke()
    assert peaks.H100_BYTES_PER_S == _constant(tree, "H100_BYTES_PER_S")
    assert peaks.H100_F32_OPS_PER_S == _constant(tree, "H100_F32_OPS_PER_S")
    cfg = program.config("tpu", {})
    ms, by = peaks.bound_ms(*peaks.sinkhorn_counts(
        cfg.k_assoc, cfg.n_meas, cfg.k_sinkhorn, 4))
    assert by == "operations" and ms == pytest.approx(1.0089e-4, rel=1e-3)
