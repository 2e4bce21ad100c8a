"""The port's one-pass Adam update (ops/cuda/adam.py) vs the JAX Pallas kernel.

``scripts/opt_layout_r4.py::fused_adam_pallas`` runs its Pallas call in
interpret mode on the CPU by itself; here the same numpy ``p, g, m, v`` go
through its ``apply_leaf`` and through ``adam_step`` (on the CPU: the plain
PyTorch version of the kernel's arithmetic) for three steps, and through
``optax.adam`` and ``torch.optim.Adam``. Tolerance: each of ``p, m, v`` within
1e-6 of the reference's largest entry (fp32 elementwise arithmetic in another
order). The multi-tensor ``adam_step_leaves`` and ``AdamLeaves`` go through the same
comparison leaf by leaf on the 52 leaf shapes of a narrow SFNO, and the launch
plan (groups of at most ``MAX_LEAVES`` leaves, chunk prefix) is checked on the
CPU. The CUDA kernel runs only on the card: tests/test_torch_cuda_kernels.py
holds it against the plain version there.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_cfd_torch.models import SFNO
from tpu_cfd_torch.ops.cuda import adam as tadam

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(20, 20, 12, 12, 5, 2), (80, 20), (10,), (1,)]
LR, B1, B2, EPS, STEPS = 1e-3, 0.9, 0.999, 1e-8, 3


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "opt_layout_r4", ROOT / "scripts" / "opt_layout_r4.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _state(shape, seed=0):
    rng = np.random.default_rng(seed)
    p, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v = (0.01 * rng.standard_normal(shape).astype(np.float32)) ** 2
    grads = [rng.standard_normal(shape).astype(np.float32) * 0.1
             for _ in range(STEPS)]
    return p, m, v, grads


def _torch_steps(p, m, v, grads, first_step=1):
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    for i, g in enumerate(grads):
        tadam.adam_step(tp, torch.from_numpy(g), tm, tv, lr=LR, b1=B1, b2=B2,
                        eps=EPS, step=first_step + i)
    return tp.numpy(), tm.numpy(), tv.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adam_step_matches_jax_pallas(shape):
    script = _load_script()
    _, apply_leaf = script.fused_adam_pallas(LR, "merge2d", b1=B1, b2=B2, eps=EPS)
    p, m, v, grads = _state(shape)
    jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
    for t, g in enumerate(grads, start=1):
        corr = jnp.asarray([1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t)],
                           jnp.float32)
        jp, jm, jv = apply_leaf(corr, jp, jm, jv, jnp.asarray(g))
    got = _torch_steps(p, m, v, grads)
    for name, a, b in zip("pmv", got, (jp, jm, jv)):
        assert a.shape == tuple(shape)
        assert _rel_err(a, b) < 1e-6, name


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adam_step_matches_optax_and_torch_optim(shape):
    """From zero moments, as both library optimizers start."""
    p, _, _, grads = _state(shape, seed=1)
    zeros = np.zeros(shape, np.float32)
    got_p, got_m, got_v = _torch_steps(p, zeros, zeros, grads)

    tx = optax.adam(LR, b1=B1, b2=B2, eps=EPS)
    jp = jnp.asarray(p)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
    assert _rel_err(got_p, jp) < 1e-6
    assert _rel_err(got_m, state[0].mu) < 1e-6
    assert _rel_err(got_v, state[0].nu) < 1e-6

    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = torch.optim.Adam([tp], lr=LR, betas=(B1, B2), eps=EPS)
    for g in grads:
        tp.grad = torch.from_numpy(g)
        opt.step()
    assert _rel_err(got_p, tp.detach().numpy()) < 1e-6
    assert _rel_err(got_m, opt.state[tp]["exp_avg"].numpy()) < 1e-6
    assert _rel_err(got_v, opt.state[tp]["exp_avg_sq"].numpy()) < 1e-6


def test_adam_step_updates_in_place_and_takes_parameters():
    p = torch.nn.Parameter(torch.ones(5))
    g, m, v = torch.full((5,), 0.5), torch.zeros(5), torch.zeros(5)
    assert tadam.adam_step(p, g, m, v, lr=LR, step=1) is None
    # the first update is -lr g/(|g| + eps), and the moments are (1-b) g, (1-b) g^2
    assert torch.allclose(p.detach(), torch.full((5,), 1 - LR), atol=1e-7)
    assert torch.allclose(m, torch.full((5,), 0.05)) and torch.allclose(
        v, torch.full((5,), 0.00025))


def test_bias_corrections():
    c1, c2 = tadam.bias_corrections(0.9, 0.999, 2)
    assert c1 == pytest.approx(1 / 0.19) and c2 == pytest.approx(1 / (1 - 0.999 ** 2))
    with pytest.raises(ValueError, match="counts from 1"):
        tadam.bias_corrections(0.9, 0.999, 0)


def test_wrapper_checks_its_inputs():
    ok = lambda: torch.zeros(4, 6)  # noqa: E731
    with pytest.raises(ValueError, match="g must be float32"):
        tadam.adam_step(ok(), ok().double(), ok(), ok(), lr=LR, step=1)
    with pytest.raises(ValueError, match="p must be float32"):
        tadam.adam_step(ok().bfloat16(), ok(), ok(), ok(), lr=LR, step=1)
    with pytest.raises(ValueError, match="m must be contiguous"):
        tadam.adam_step(ok(), ok(), torch.zeros(6, 4).t(), ok(), lr=LR, step=1)
    with pytest.raises(ValueError, match="v has shape"):
        tadam.adam_step(ok(), ok(), ok(), torch.zeros(24), lr=LR, step=1)
    with pytest.raises(ValueError, match="g must be float32 on cpu"):
        tadam.adam_step(ok(), ok().to("meta"), ok(), ok(), lr=LR, step=1)
    with pytest.raises(ValueError, match="counts from 1"):
        tadam.adam_step(ok(), ok(), ok(), ok(), lr=LR, step=0)


def test_non_cpu_tensors_never_fall_back():
    meta = lambda: torch.zeros(4, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no Adam kernel"):
        tadam.adam_step(meta(), meta(), meta(), meta(), lr=LR, step=1)
    if not torch.cuda.is_available():
        t = lambda: torch.zeros(4)  # noqa: E731
        with pytest.raises(RuntimeError):  # no nvcc, no card: it raises
            tadam._launch_adam(t(), t(), t(), t(), LR, B1, B2, EPS, 1)


def test_bytes_of_the_bound():
    # four streams read and three written, 4 B each: what chip_smoke.py's bound uses
    assert tadam.BYTES_PER_ELEMENT == 28
    assert tadam.BYTES_PER_ELEMENT * 16_469_791 == 461_154_148


# the 52 leaf shapes of a narrow SFNO (4 spectral layers, width 4, modes 4/4/3)
NARROW_SFNO_SHAPES = [tuple(p.shape) for p in SFNO(
    modes_x=4, modes_y=4, modes_t=3, width=4, output_steps=4, latent_steps=4,
).parameters()]


@pytest.mark.parametrize("table", [False, True])  # adam_step_leaves, AdamLeaves
def test_adam_step_leaves_matches_jax_pallas(table):
    """All leaves of a narrow SFNO in one call a step, against the JAX kernel
    leaf by leaf, over three steps."""
    assert len(NARROW_SFNO_SHAPES) == 52
    script = _load_script()
    _, apply_leaf = script.fused_adam_pallas(LR, "merge2d", b1=B1, b2=B2, eps=EPS)
    states = [_state(sh, seed=i) for i, sh in enumerate(NARROW_SFNO_SHAPES)]
    want = []
    for p, m, v, grads in states:
        jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
        for t, g in enumerate(grads, start=1):
            corr = jnp.asarray([1.0 / (1.0 - B1 ** t), 1.0 / (1.0 - B2 ** t)],
                               jnp.float32)
            jp, jm, jv = apply_leaf(corr, jp, jm, jv, jnp.asarray(g))
        want.append((jp, jm, jv))
    ps, ms, vs = ([torch.from_numpy(st[k].copy()) for st in states] for k in range(3))
    kept = tadam.AdamLeaves(ps, ms, vs)
    for t in range(STEPS):
        gs = [torch.from_numpy(st[3][t]) for st in states]
        if table:
            kept.step(gs, lr=LR, b1=B1, b2=B2, eps=EPS, step=t + 1)
        else:
            tadam.adam_step_leaves(ps, gs, ms, vs, lr=LR, b1=B1, b2=B2, eps=EPS,
                                   step=t + 1)
    for i, (got, ref) in enumerate(zip(zip(ps, ms, vs), want)):
        for name, a, b in zip("pmv", got, ref):
            assert _rel_err(a.numpy(), b) < 1e-6, (i, NARROW_SFNO_SHAPES[i], name)


@pytest.mark.parametrize("leaves", [1, 64, 65, 130])
def test_plan_launches_groups_and_chunk_prefix(leaves):
    rng = np.random.default_rng(leaves)
    numels = [int(n) for n in rng.integers(1, 3 * tadam.CHUNK, size=leaves)]
    groups = tadam.plan_launches(numels)
    assert len(groups) == -(-leaves // tadam.MAX_LEAVES)
    assert [i for idx, _, _ in groups for i in idx] == list(range(leaves))
    for idx, first, chunks in groups:
        assert 1 <= len(idx) <= tadam.MAX_LEAVES and len(first) == len(idx)
        # leaf k of the group owns chunks [first[k], first[k + 1]), the last
        # one up to the group's total
        ends = first[1:] + [chunks]
        assert first[0] == 0
        for i, a, b in zip(idx, first, ends):
            assert b - a == -(-numels[i] // tadam.CHUNK)


def test_plan_launches_skips_empty_leaves():
    numels = [0, 5, 0, 0, tadam.CHUNK, tadam.CHUNK + 1] + [1] * 70 + [0]
    groups = tadam.plan_launches(numels)
    idx = [i for g in groups for i in g[0]]
    assert idx == [1, 4, 5] + list(range(6, 76))
    assert [len(g[0]) for g in groups] == [64, 9]
    assert groups[0][1][:4] == [0, 1, 2, 4] and groups[1][1][0] == 0
    assert tadam.plan_launches([0, 0]) == []


def test_adam_leaves_checks_its_inputs():
    ok = lambda: torch.zeros(4, 6)  # noqa: E731
    with pytest.raises(ValueError, match="2 params, 1 ms and 2 vs"):
        tadam.AdamLeaves([ok(), ok()], [ok()], [ok(), ok()])
    with pytest.raises(ValueError, match=r"ms\[1\] has shape"):
        tadam.AdamLeaves([ok(), ok()], [ok(), torch.zeros(3)], [ok(), ok()])
    with pytest.raises(ValueError, match=r"vs\[0\] must be contiguous"):
        tadam.AdamLeaves([ok()], [ok()], [torch.zeros(6, 4).t()])
    kept = tadam.AdamLeaves([ok(), ok()], [ok(), ok()], [ok(), ok()])
    with pytest.raises(ValueError, match="1 grads for 2 leaves"):
        kept.step([ok()], lr=LR, step=1)
    with pytest.raises(ValueError, match=r"grads\[1\] must be float32 on cpu"):
        kept.step([ok(), ok().double()], lr=LR, step=1)
    with pytest.raises(ValueError, match="counts from 1"):
        kept.step([ok(), ok()], lr=LR, step=0)
    meta = lambda: torch.zeros(4, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no Adam kernel"):
        tadam.adam_step_leaves([meta()], [meta()], [meta()], [meta()], lr=LR, step=1)
    # no leaves: nothing to do
    tadam.adam_step_leaves([], [], [], [], lr=LR, step=1)
