"""The port's optimizer sweep (train/opt_layout.py) vs scripts/opt_layout_r4.py.

At a small size (16², width 8, modes 4/4/3, t 4 → 8, batch 2) on the CPU,
where ``adam_step`` runs its plain version: each variant's ``--check``
against ``base``, in fp32 and with bf16 activations, and the loss after three
steps against the JAX script's ``build_step("fused_adam")`` from the same
(converted) parameters and the same numpy inputs, to ``rtol=1e-4`` (three
fp32 train steps of two frameworks).
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_cfd import models as jm
from tpu_cfd.train import losses as jlosses
from tpu_cfd_torch import convert
from tpu_cfd_torch import models as tm
from tpu_cfd_torch.train import losses as tlosses, opt_layout

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(batch=2, n=16, t_in=4, t_out=8, width=8, modes=(4, 4, 3),
             latent_steps=4, device="cpu")


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "opt_layout_r4", ROOT / "scripts" / "opt_layout_r4.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("variant", opt_layout.VARIANTS)
def test_bench_variant_check(variant, compute_dtype):
    row = opt_layout.bench_variant(variant, n_calls=2, scan=2, check=True,
                                   compute_dtype=compute_dtype, **SMALL)
    assert row["variant"] == variant and row["scan"] == 2 and row["batch"] == 2
    assert row["compute_dtype"] == (compute_dtype or "float32")
    assert row["device"] == "cpu"
    assert np.isfinite(row["loss"]) and row["ms_step"] > 0
    assert row["samples_per_s"] == pytest.approx(2 / (row["ms_step"] * 1e-3))
    chk = row["check"]
    assert abs(chk["loss"] - chk["base_loss"]) <= 2e-5 * abs(chk["base_loss"])
    # 3 checked steps, one warm-up call and 2 timed calls of 2 steps each
    assert row["steps"] == 3 + 3 * 2
    assert row["leaves"] == 52


def test_fused_adam_step_matches_the_jax_script():
    script = _load_script()
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=8, beta=1e-2,
              output_steps=8, latent_steps=4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    y = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    jmod = jm.SFNO(**kw)
    params = jax.jit(lambda k, v: jmod.init(k, v, out_steps=8))(
        jax.random.PRNGKey(0), x)
    jstep, carry = script.build_step(
        "fused_adam", jmod, jlosses.SobolevLoss(n_grid=16, norm_order=0,
                                                relative=True), params, 8)
    jstep = jax.jit(jstep)

    tmod = tm.SFNO(**kw)
    tmod.load_state_dict(convert.sfno_state_dict_from_flax(jax.device_get(params)))
    tstep = opt_layout.build_step(
        "fused_adam", tmod, tlosses.SobolevLoss(n_grid=16, norm_order=0,
                                                relative=True), 8)
    for _ in range(3):
        carry, loss_j = jstep(carry, x, y)
        loss_t = tstep(torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    # the parameters moved together too: the largest leaf, to 1e-4 of its largest entry
    new = convert.sfno_state_dict_from_flax(jax.device_get(carry[0]))
    name = "convs.0.weight_0"
    got, want = tmod.state_dict()[name].numpy(), new[name].numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fused_adam_updates_all_leaves_in_one_call_a_step(monkeypatch):
    """The ``fused_adam`` step checks and plans its leaves once and then
    makes one multi-tensor call a step over all 52 of them."""
    from tpu_cfd_torch.ops.cuda import adam as tadam

    built, calls = [], []
    init, step_ = tadam.AdamLeaves.__init__, tadam.AdamLeaves.step

    def counting_init(self, params, ms, vs):
        built.append(len(params))
        init(self, params, ms, vs)

    def counting_step(self, grads, **kw):
        calls.append((len(grads), kw["step"]))
        step_(self, grads, **kw)

    monkeypatch.setattr(tadam.AdamLeaves, "__init__", counting_init)
    monkeypatch.setattr(tadam.AdamLeaves, "step", counting_step)
    model = tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=8, output_steps=8,
                    latent_steps=4)
    step = opt_layout.build_step("fused_adam", model, tlosses.SobolevLoss(
        n_grid=16, norm_order=0, relative=True), 8)
    x, y = torch.randn(2, 16, 16, 4), torch.randn(2, 16, 16, 8)
    for _ in range(3):
        step(x, y)
    assert built == [52] and calls == [(52, 1), (52, 2), (52, 3)]


def test_gradients_reach_adam_step_contiguous():
    """``adam_step`` raises on a non-contiguous tensor: every leaf's gradient
    has its parameter's (contiguous) layout."""
    model = tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=8, output_steps=8,
                    latent_steps=4)
    x, y = torch.randn(2, 16, 16, 4), torch.randn(2, 16, 16, 8)
    tlosses.SobolevLoss(n_grid=16, norm_order=0, relative=True)(
        model(x, out_steps=8), y).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.is_contiguous(), name


@pytest.mark.parametrize("variant", opt_layout.TPU_ONLY_VARIANTS)
def test_tpu_only_variants_are_refused_by_name(variant):
    with pytest.raises(ValueError, match=f"'{variant}' is a TPU lane-tiling lever"):
        opt_layout.main(["--no-cuda", "--variants", f"base,{variant}"])
    with pytest.raises(ValueError, match=variant):
        opt_layout.bench_variant(variant, **SMALL)


def test_unknown_variant_and_missing_card():
    with pytest.raises(ValueError, match="unknown variant 'adamw'"):
        opt_layout.build_step("adamw", torch.nn.Linear(2, 2), None, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt_layout.main(["--variants", "base"])
