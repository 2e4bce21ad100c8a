"""The port's tensor parallelism (``tpu_cfd_torch.parallel``) on the CPU.

What the JAX package's ``tests/test_parallel.py`` holds for its 8-device
mesh and ``__graft_entry__.dryrun_multichip`` runs, held here on gloo: at
world 4 (``data`` 2 × ``model`` 2) the mesh's layout, parameters that are
actually sharded, the dp × tp SFNO train step against the unsharded port
and against JAX's unsharded step on the same weights (loss rtol 1e-6,
parameters rtol 1e-5, atol 1e-6), the batch-sharded solver (rtol 1e-6, atol
1e-8), the pencil-sharded solver step against the replicated one (64², b=4,
10 steps, rtol 1e-5, atol 1e-5 as complex numbers) and the data-parallel
fine-tune (history and parameters rtol 1e-5, atol 1e-7), the pencil FFT pair
at 64² (33 columns over 2 ranks), and the train step on a model axis of 4;
FNO3d's placements against JAX's ``sfno_param_spec`` leaf by leaf (model
axes 2 and 4, widths 10 and 8) and its dp × tp train step (modes 4/4/2,
width 8, 16², t 4) against the unsharded port and JAX's unsharded step at
the SFNO's tolerances, with remat, with padding, on a model axis of 4, and in
bfloat16 as the SFNO's; then the dry run's CLI at worlds 4 and 2.

One spawn runs all of the world's cases: each rank records each case's
outcome, and each test asserts its own. The JAX references are computed in
this process (JAX's CPU mesh, ``tests/conftest.py``) and reach the workers
as numpy; the workers import no JAX. Every process group has a 60 s timeout
and every spawn a deadline, so a hung collective fails a test.
"""

import datetime
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_cfd_torch import parallel

torch.set_num_threads(2)

PG_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_DEADLINE_S = 240
SFNO_KW = dict(modes_x=4, modes_y=4, modes_t=2, width=8, latent_steps=4,
               num_spectral_layers=2)
T_WIN, FT_BATCH = 4, 4  # the fine-tune's window; its batch, 2 a data rank
FNO3D_KW = dict(modes1=4, modes2=4, modes3=2, width=8, num_spectral_layers=2,
                channel_expansion=16)
FNO3D_T = 4  # output steps of the FNO3d train step; its input is (8, 16, 16, 4, 13)
# FNO3d's placements are held to JAX's at the example's width 10 (where a model
# axis of 4 shards only the head's 128 hidden units) and at a width 4 divides
FNO3D_PLACEMENT_CASES = [(width, mp) for width in (10, 8) for mp in (2, 4)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(rank, world, init, cases, ref, out_dir):
    """One rank: joins the gloo world, runs each case in order, records
    "ok" or the error; after a case fails on any rank the rest are not run
    (its collectives may be left unmatched)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=PG_TIMEOUT)
    results = {}
    try:
        for name in cases:
            try:
                CASES[name](rank, ref)
                results[name] = "ok"
            except Exception:  # recorded for the test of this case
                results[name] = f"rank {rank}: {traceback.format_exc(limit=-2)}"
            ok = torch.tensor([int(results[name] == "ok")])
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            if not ok.item():
                break
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()


def _spawn_world(tmp, world, cases, ref):
    """Runs ``cases`` on ``world`` gloo ranks; ``{case: outcome}`` (the
    first rank's error where any failed, "not run" after a failure)."""
    ctx = mp.spawn(_worker, args=(world, f"file://{tmp}/store", cases, ref, str(tmp)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"world {world} did not finish within {SPAWN_DEADLINE_S} s")
    per_rank = [json.load(open(tmp / f"rank{r}.json")) for r in range(world)]
    first = next((c for c in cases if any(r.get(c) != "ok" for r in per_rank)), None)
    return {c: next((r.get(c, f"not run: {first} failed first") for r in per_rank
                     if r.get(c) != "ok"), "ok") for c in cases}


def _sfno(state, **kw):
    from tpu_cfd_torch.models import SFNO

    model = SFNO(**{**SFNO_KW, **kw})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _fno3d(state, **kw):
    from tpu_cfd_torch.models import FNO3d

    model = FNO3d(**{**FNO3D_KW, **kw})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------------------------------------ world 4 cases

def _mesh_case(rank, ref):
    mesh = parallel.make_mesh(model_parallel=2)
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 2, "model": 2}
    # the model axis is the fast one: ranks 2d, 2d+1 form model group d
    assert mesh.mesh.tolist() == [[0, 1], [2, 3]]
    assert (mesh.get_local_rank("data"), mesh.get_local_rank("model")) == divmod(rank, 2)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.make_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="n_devices"):
        parallel.make_mesh(n_devices=8, model_parallel=2)


def _params_case(rank, ref):
    from torch.distributed.tensor import Replicate, Shard

    mesh = parallel.make_mesh(model_parallel=2)
    full = _sfno(ref["init"]).state_dict()
    model = parallel.shard_params(_sfno(ref["init"]), mesh)
    placed = parallel.sharded_parameters(model)
    sharded = {k: d for k, d in placed.items() if isinstance(d.placements[0], Shard)}
    assert sharded, "no parameter is sharded on the model axis"
    for k, d in sharded.items():
        dim = d.placements[0].dim
        assert d.to_local().shape[dim] == full[k].shape[dim] // 2, k
        want = torch.chunk(full[k], 2, dim=dim)[mesh.get_local_rank("model")]
        assert torch.equal(d.to_local(), want), k
    # JAX's rule in the port's layouts, with Megatron's FFN
    assert placed["convs.0.weight_0"].placements == (Shard(4),)  # (mx, my, mt, ci, co, 2)
    assert placed["lifting.conv.weight_2"].placements == (Shard(4),)
    assert placed["skips.0.weight"].placements == (Shard(0),)
    assert placed["skips.0.bias"].placements == (Shard(0),)
    assert placed["ffns.0.dense_0.weight"].placements == (Shard(0),)
    assert placed["ffns.0.dense_1.weight"].placements == (Shard(1),)
    for k in ("ffns.0.dense_1.bias", "lifting.norm.scale", "lifting.norm.bias",
              "reduce.weight", "out_conv.conv.weight_0", "out_conv.conv.bias_0"):
        assert placed[k].placements == (Replicate(),), k
    for k, v in parallel.gather_parameters(model).items():
        assert torch.equal(v, full[k]), k


def _train_step(model, v, y, mesh=None):
    from tpu_cfd_torch.train import losses

    loss_obj = losses.SobolevLoss(n_grid=16, norm_order=-1, relative=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = loss_obj(model(v), y)
    loss.backward()
    if mesh is not None:
        parallel.average_gradients(model.parameters(), mesh)
        loss = parallel.mean_over(loss, mesh)
    opt.step()
    return float(loss)


def _train_case(rank, ref, model_parallel=2):
    """dp × tp against the unsharded port and JAX's unsharded step."""
    mesh = parallel.make_mesh(model_parallel=model_parallel)
    v, y = (torch.from_numpy(ref[k]) for k in ("v", "y"))
    single = _sfno(ref["init"])
    loss_1 = _train_step(single, v, y)
    model = parallel.shard_params(_sfno(ref["init"]), mesh)
    loss = _train_step(model, parallel.shard_batch(v, mesh), parallel.shard_batch(y, mesh),
                       mesh)
    got = parallel.gather_parameters(model)
    _close(loss, loss_1, 1e-6, 0, "loss against the unsharded port")
    _close(loss, ref["loss"], 1e-6, 0, "loss against JAX")
    for k, p in single.named_parameters():
        _close(got[k], p.detach(), 1e-5, 1e-6, f"{k} against the unsharded port")
        _close(got[k], ref["new"][k], 1e-5, 1e-6, f"{k} against JAX")


def _train_bf16_case(rank, ref):
    """The dp × tp train step in bfloat16 against the unsharded port's. The
    sharded FFN rounds its output twice (each rank's partial in the kernel,
    the float32 sum of the partials once more) where the unsharded kernel
    rounds once. The loss is held to the unsharded one to rtol 2⁻⁹ (one
    bfloat16 rounding); each leaf's gradient lies no farther (max abs) from
    the float32 step's than 1.25 × the unsharded bfloat16 gradient's own
    distance from it: sharding may add a quarter to bfloat16's error, no
    more. Adam's first step moves a parameter by at most its lr whatever its
    gradient, so a gradient near 0 whose sign the roundings flip puts two
    steps 2·lr apart: the parameters are held to atol 2e-3."""
    from torch.distributed.tensor import DTensor

    from tpu_cfd_torch.train import losses

    mesh = parallel.make_mesh(model_parallel=2)
    v, y = (torch.from_numpy(ref[k]) for k in ("v", "y"))
    loss_obj = losses.SobolevLoss(n_grid=16, norm_order=-1, relative=True)

    def step(model, mesh=None):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        vs, ys = (v, y) if mesh is None else (parallel.shard_batch(t, mesh) for t in (v, y))
        loss = loss_obj(model(vs), ys)
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        if mesh is not None:
            parallel.average_gradients(model.parameters(), mesh)
            loss = parallel.mean_over(loss.detach(), mesh)
            grads = {k: DTensor.from_local(p.grad, mesh["model"], [model.tp_placements[k]],
                                           run_check=False).full_tensor()
                     for k, p in model.named_parameters()}
        opt.step()
        return float(loss.detach()), grads

    _, grads_32 = step(_sfno(ref["init"]))
    single = _sfno(ref["init"], compute_dtype="bfloat16")
    loss_1, grads_1 = step(single)
    model = parallel.shard_params(_sfno(ref["init"], compute_dtype="bfloat16"), mesh)
    loss, grads = step(model, mesh)
    got = parallel.gather_parameters(model)
    assert np.isfinite(loss)
    _close(loss, loss_1, 2**-9, 0, "bfloat16 loss against the unsharded port")
    for k, p in single.named_parameters():
        g32 = grads_32[k]
        err, err_1 = (float((g[k] - g32).abs().max()) for g in (grads, grads_1))
        assert err <= 1.25 * err_1, (f"{k}.grad: sharded bfloat16 {err:.3e} from float32, "
                                     f"unsharded bfloat16 {err_1:.3e}")
        _close(got[k], p.detach(), 0, 2e-3, f"{k} (bfloat16) against the unsharded port")


def _solver_case(rank, ref):
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    mesh = parallel.make_mesh(model_parallel=2)
    n = 32
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, device="cpu")
    w0 = np.random.default_rng(0).standard_normal((8, n, n)).astype(np.float32)
    what = torch.fft.rfft2(torch.from_numpy(w0))
    want = ns.forward(what, 1e-3, steps=5)[0]
    got = ns.forward(parallel.shard_batch(what, mesh), 1e-3, steps=5)[0]
    _close(got, parallel.shard_batch(want, mesh), 1e-6, 1e-8, "batch-sharded solver")


def _pencil_step_case(rank, ref):
    from torch.distributed.tensor import Shard

    from tpu_cfd_torch import grids
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    mesh = parallel.make_mesh(model_parallel=2)
    n = 64
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, device="cpu")
    w0 = np.random.default_rng(7).standard_normal((4, n, n)).astype(np.float32)
    what = torch.fft.rfft2(torch.from_numpy(w0))
    want = ns.forward(what, 1e-3, steps=10)[0]
    pencil = parallel.shard_field_spatial(what, mesh, spatial_axis=-2)
    assert Shard(1) in pencil.placements and pencil.to_local().shape == (4, n // 2, 33)
    out = ns.forward(pencil, 1e-3, steps=10)[0]
    assert out.placements == pencil.placements
    rows = torch.chunk(want, 2, dim=-2)[mesh.get_local_rank("model")]
    _close(out.to_local(), rows, 1e-5, 1e-5, "pencil-sharded step (complex)")
    _close(out.full_tensor(), want, 1e-5, 1e-5, "pencil-sharded step, assembled")


def _finetune_case(rank, ref):
    """tests/test_parallel.py:471-513 on its own SFNO init and inputs: 3 Adam
    steps of the OutConvFT through the CN solver, the latents sharded on
    data, the parameters replicated."""
    from tpu_cfd_torch.models import forward_with_latents
    from tpu_cfd_torch.train import finetune

    mesh = parallel.make_mesh(model_parallel=2)
    model = _sfno(ref["init"], output_steps=T_WIN)
    w_in = torch.from_numpy(ref["w_in"])
    with torch.no_grad():
        v_latent = forward_with_latents(model, w_in, out_steps=T_WIN)[1]["r"]

    def outconv():
        return finetune.build_finetune_outconv(
            model.out_conv.conv, (4, 4, 2), (5, 5, 2), out_steps=T_WIN,
            generator=torch.Generator().manual_seed(7), visc=1e-3, dt=1e-6, diam=1.0,
            finetune=True)

    ft_ref, ft_sh = outconv(), parallel.replicate(outconv(), mesh)
    hist_ref = finetune.finetune_steps(ft_ref, v_latent, w_in, None, out_steps=T_WIN,
                                       n_steps=3, lr=1e-3)
    hist_sh = finetune.finetune_steps(
        ft_sh, parallel.shard_batch(v_latent, mesh), parallel.shard_batch(w_in, mesh),
        None, out_steps=T_WIN, n_steps=3, lr=1e-3, mesh=mesh)
    assert np.isfinite(hist_sh).all() and len(hist_sh) == 4
    _close(hist_sh, hist_ref, 1e-5, 1e-7, "fine-tune history")
    for (k, p), q in zip(ft_sh.named_parameters(), ft_ref.parameters()):
        _close(p.detach(), q.detach(), 1e-5, 1e-7, k)


def _refusal_case(rank, ref):
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    mesh = parallel.make_mesh(model_parallel=2)
    # a module whose layers the port does not know (FNO3d's it does, since
    # tensor parallelism of FNO3d was ported)
    with pytest.raises(TypeError, match="knows the layers of SFNO, FNO3d, not Sequential"):
        parallel.shard_params(torch.nn.Sequential(torch.nn.Linear(4, 8)), mesh)
    model = parallel.shard_params(_sfno(ref["init"]), mesh)
    with pytest.raises(ValueError, match="sharded already"):
        parallel.shard_params(model, mesh)
    grid = grids.Grid((16, 16), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    what = torch.fft.rfft2(torch.ones(2, 16, 16))
    for kw in (dict(fft_impl="dft_aligned", fused=True), dict(fft_impl="dft_galerkin")):
        ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, device="cpu", **kw)
        with pytest.raises(ValueError, match="pencil-sharded field"):
            ns.forward(parallel.shard_field_spatial(what, mesh), 1e-3, 1)


def _fno3d_params_case(rank, ref):
    """At model axes 2 and 4, widths 10 and 8: every leaf's placement is JAX's
    ``sfno_param_spec`` of the flax leaf that ``convert.py`` maps it to (a
    Dense kernel sharded on ``out``, dim 1 of ``(in, out)``, is ``Shard(0)``
    of the port's ``(out, in)`` weight), with each bias placed as its weight
    (JAX replicates biases; the port shards a sharded layer's bias with its
    output channels)."""
    from torch.distributed.tensor import Replicate, Shard

    from tpu_cfd_torch.models import FNO3d

    for width, mp in FNO3D_PLACEMENT_CASES:
        mesh = parallel.make_mesh(model_parallel=mp)
        want = {k: Replicate() if d is None else Shard(d)
                for k, d in ref["fno3d_specs"][f"{width}/{mp}"].items()}
        model = parallel.shard_params(FNO3d(4, 4, 2, width), mesh)
        assert model.tp_placements == want, (width, mp, {
            k: (model.tp_placements.get(k), want.get(k)) for k in set(want) | set(
                model.tp_placements) if model.tp_placements.get(k) != want.get(k)})
        sharded = {k for k, pl in want.items() if isinstance(pl, Shard)}
        # width 10 on 4 ranks: the head's hidden units alone are sharded
        if (width, mp) == (10, 4):
            assert sharded == {"head.dense_0.weight", "head.dense_0.bias"}, sharded
        else:
            assert len(sharded) == len(want) - 2, sharded  # all but the head's dense_1
        full = dict(FNO3d(4, 4, 2, width).named_parameters())
        for k, local in model.named_parameters():
            pl = want[k]
            if isinstance(pl, Shard):
                assert local.shape[pl.dim] == full[k].shape[pl.dim] // mp, k
            else:
                assert local.shape == full[k].shape, k


def _fno3d_step(model, x, y, mesh=None):
    """One Adam step of the FNO3d trainer's loss (``train/train_fno3d.py``:
    the relative Sobolev norm of order 0 on the prediction); the loss and
    the gradients, whole (a sharded model's gathered over its group)."""
    from torch.distributed.tensor import DTensor

    from tpu_cfd_torch.train import losses

    loss_obj = losses.SobolevLoss(n_grid=16, norm_order=0, relative=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = loss_obj(model(x)[0], y)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    if mesh is not None:
        parallel.average_gradients(model.parameters(), mesh)
        loss = parallel.mean_over(loss.detach(), mesh)
        grads = {k: DTensor.from_local(p.grad, mesh["model"], [model.tp_placements[k]],
                                       run_check=False).full_tensor()
                 for k, p in model.named_parameters()}
    opt.step()
    return float(loss.detach()), grads


def _fno3d_train_case(rank, ref, model_parallel=2, **kw):
    """dp × tp FNO3d against the unsharded port and JAX's unsharded step; the
    replicated head's ``dense_1`` gets its whole gradient on every rank.
    With ``padding`` the JAX step (unpadded) is not the reference. Against
    JAX, by ``tests/test_torch_train.py``'s one-Adam-step rule: each leaf's
    gradient within 1e-4 of its largest entry (at least 1 % of the model's
    largest), and the parameters where JAX's gradient stands above its leaf's
    fp32 noise and 100 × Adam's eps: below that the first update, -lr·g/(|g|
    + eps), turns the gradient's roundoff into up to lr (one entry of 4,096
    of ``convs.1.weight_0``, |g| = 6.4e-10, lies 1.5e-6 from JAX's in the
    unsharded port too)."""
    mesh = parallel.make_mesh(model_parallel=model_parallel)
    x, y = (torch.from_numpy(ref[k]) for k in ("fno3d_x", "fno3d_y"))
    single = _fno3d(ref["fno3d_init"], **kw)
    loss_1, grads_1 = _fno3d_step(single, x, y)
    model = parallel.shard_params(_fno3d(ref["fno3d_init"], **kw), mesh)
    assert any(type(pl).__name__ == "Shard" for pl in model.tp_placements.values())
    loss, grads = _fno3d_step(model, parallel.shard_batch(x, mesh),
                              parallel.shard_batch(y, mesh), mesh)
    got = parallel.gather_parameters(model)
    _close(loss, loss_1, 1e-6, 0, "FNO3d loss against the unsharded port")
    # the data ranks hold half the batch each: their gradients' mean is the whole's
    _close(grads["head.dense_1.weight"], grads_1["head.dense_1.weight"], 1e-5, 1e-7,
           "the replicated head.dense_1's gradient against the unsharded port")
    for k, p in single.named_parameters():
        _close(got[k], p.detach(), 1e-5, 1e-6, f"FNO3d {k} against the unsharded port")
    if "padding" not in kw:
        _close(loss, ref["fno3d_loss"], 1e-6, 0, "FNO3d loss against JAX")
        floor = 1e-2 * max(np.abs(g).max() for g in ref["fno3d_grads"].values())
        for k, p in single.named_parameters():
            g_j = ref["fno3d_grads"][k]
            leaf = max(np.abs(g_j).max(), floor)
            _close(grads[k], g_j, 0, 1e-4 * leaf, f"FNO3d {k}.grad against JAX")
            big = np.abs(g_j) > max(1e-3 * leaf, 1e-6)
            _close(got[k].numpy()[big], ref["fno3d_new"][k][big], 1e-5, 1e-6,
                   f"FNO3d {k} against JAX")


def _fno3d_train_bf16_case(rank, ref):
    """The dp × tp FNO3d step in bfloat16 against the unsharded port's, held
    as ``_train_bf16_case`` holds the SFNO's: the loss to rtol 2⁻⁹, each
    leaf's gradient no farther from the float32 step's than a bound times
    the unsharded bfloat16 gradient's distance, the parameters to atol 2e-3.
    The bound is 2, not the SFNO's 1.25: every FNO3d layer is column
    parallel, and the gradient of its bfloat16 input is rounded twice (each
    rank's partial in the layer's backward, then their sum) where the
    unsharded layer rounds it once; the other roundings are shared, so the
    distance at most doubles (measured on gloo: 1.55 at most, on
    ``convs.1.weight_1``; 1.00 with the model axis of one rank)."""
    mesh = parallel.make_mesh(model_parallel=2)
    x, y = (torch.from_numpy(ref[k]) for k in ("fno3d_x", "fno3d_y"))
    xs, ys = parallel.shard_batch(x, mesh), parallel.shard_batch(y, mesh)
    _, grads_32 = _fno3d_step(_fno3d(ref["fno3d_init"]), x, y)
    single = _fno3d(ref["fno3d_init"], compute_dtype="bfloat16")
    loss_1, grads_1 = _fno3d_step(single, x, y)
    model = parallel.shard_params(_fno3d(ref["fno3d_init"], compute_dtype="bfloat16"), mesh)
    loss, grads = _fno3d_step(model, xs, ys, mesh)
    got = parallel.gather_parameters(model)
    assert np.isfinite(loss)
    _close(loss, loss_1, 2**-9, 0, "FNO3d bfloat16 loss against the unsharded port")
    for k, p in single.named_parameters():
        g32 = grads_32[k]
        err, err_1 = (float((g[k] - g32).abs().max()) for g in (grads, grads_1))
        assert err <= 2 * err_1, (f"FNO3d {k}.grad: sharded bfloat16 {err:.3e} from "
                                  f"float32, unsharded bfloat16 {err_1:.3e}")
        _close(got[k], p.detach(), 0, 2e-3, f"FNO3d {k} (bfloat16) against the unsharded")


def _pencil_fft_case(rank, ref):
    from tpu_cfd_torch.parallel import pencil

    mesh = parallel.make_mesh(model_parallel=2)
    group, r = mesh.get_group("model"), mesh.get_local_rank("model")
    n = 64  # 33 columns over 2 ranks: padded to 34
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, n, n)))
    xh = torch.fft.rfft2(x)
    slab = parallel.shard_field_spatial(xh, mesh).to_local()
    rows = torch.chunk(x, 2, dim=-2)[r]
    _close(pencil.irfft2(slab, n, group), rows, 1e-12, 1e-12, "pencil irfft2")
    _close(pencil.rfft2(rows, group), slab, 1e-12, 1e-12, "pencil rfft2")
    _close(pencil.irfft2(pencil.rfft2(rows, group), n, group), rows, 1e-12, 1e-12,
           "pencil round trip")


CASES = {"mesh": _mesh_case, "params": _params_case, "train_step": _train_case,
         "train_step_model4": lambda rank, ref: _train_case(rank, ref, model_parallel=4),
         "train_step_bf16": _train_bf16_case,
         "solver": _solver_case, "pencil_fft": _pencil_fft_case,
         "pencil_step": _pencil_step_case, "finetune": _finetune_case,
         "refusals": _refusal_case, "fno3d_params": _fno3d_params_case,
         "fno3d_train_step": _fno3d_train_case,
         "fno3d_train_step_remat": lambda rank, ref: _fno3d_train_case(rank, ref, remat=True),
         "fno3d_train_step_padding": lambda rank, ref: _fno3d_train_case(rank, ref, padding=2),
         "fno3d_train_step_model4": lambda rank, ref: _fno3d_train_case(rank, ref,
                                                                        model_parallel=4),
         "fno3d_train_step_bf16": _fno3d_train_bf16_case}


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's unsharded SFNO train step (tests/test_parallel.py:60-99) on its
    own init, as the port's state_dicts: before, after, and the loss; and
    the sharded fine-tune test's SFNO init and inputs."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_cfd.models import SFNO as JaxSFNO
    from tpu_cfd.train import losses as jax_losses
    from tpu_cfd_torch import convert

    model = JaxSFNO(**SFNO_KW)
    rng = np.random.default_rng(0)
    v, y = (rng.normal(size=(8, 16, 16, 6)).astype(np.float32) for _ in range(2))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(v))
    loss_obj = jax_losses.SobolevLoss(n_grid=16, norm_order=-1, relative=True)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(lambda q: loss_obj(model.apply(q, v), y))(p)
        updates, _ = opt.update(grads, opt.init(p))
        return optax.apply_updates(p, updates), loss

    new, loss = jax.device_get(step(params))
    fno3d = _jax_fno3d_refs()
    # the sharded fine-tune test's inputs (tests/test_parallel.py:480-489); its
    # SFNO's init is this one (the same key and parameter shapes)
    w_in = np.random.default_rng(5).normal(size=(FT_BATCH, 16, 16, T_WIN)).astype(np.float32)
    as_np = lambda tree: {k: t.numpy() for k, t in  # noqa: E731
                          convert.sfno_state_dict_from_flax(jax.device_get(tree)).items()}
    return {"v": v, "y": y, "init": as_np(params), "new": as_np(new), "loss": float(loss),
            "w_in": w_in, **fno3d}


def _jax_fno3d_refs() -> dict:
    """JAX's side of the FNO3d cases: ``sfno_param_spec`` on FNO3d's flax tree
    at each of ``FNO3D_PLACEMENT_CASES`` as ``{port name: sharded dim or None}``
    (through ``convert.py``'s names), and JAX's unsharded FNO3d train step on
    its own init (before, after, the loss) as the port's state_dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_cfd.models import FNO3d as JaxFNO3d
    from tpu_cfd.parallel import mesh as jax_mesh
    from tpu_cfd.train import losses as jax_losses
    from tpu_cfd_torch import convert

    specs = {}
    for width, mp in FNO3D_PLACEMENT_CASES:
        model = JaxFNO3d(4, 4, 2, width)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 4, 13), jnp.float32))["params"]
        mesh = jax_mesh.make_mesh(n_devices=4, model_parallel=mp)
        flat = {tuple(getattr(k, "key", k) for k in path): jax_mesh.sfno_param_spec(
                    path, leaf, mesh)
                for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        names = convert._key_map("FNO3d", shapes)  # flax path -> (port name, transposed)
        dims = {}
        for path, spec in flat.items():
            name, transposed = names[path]
            axes = [i for i, a in enumerate(spec) if a == "model"]
            assert len(axes) <= 1, (path, spec)
            dim = axes[0] if axes else None
            dims[name] = dim if dim is None or not transposed else 1 - dim
        for name in dims:  # a bias goes with its weight
            if name.endswith(".bias"):
                dims[name] = dims[name[:-len("bias")] + "weight"]
        specs[f"{width}/{mp}"] = dims

    model = JaxFNO3d(**FNO3D_KW)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16, 16, FNO3D_T, 13)).astype(np.float32)
    y = rng.normal(size=(8, 16, 16, FNO3D_T)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    loss_obj = jax_losses.SobolevLoss(n_grid=16, norm_order=0, relative=True)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(
            lambda q: loss_obj(model.apply(q, x)[0], y))(p)
        updates, _ = opt.update(grads, opt.init(p))
        return optax.apply_updates(p, updates), loss, grads

    new, loss, grads = jax.device_get(step(params))
    as_np = lambda tree: {k: t.numpy() for k, t in  # noqa: E731
                          convert.fno3d_state_dict_from_flax(jax.device_get(tree)).items()}
    return {"fno3d_specs": specs, "fno3d_x": x, "fno3d_y": y,
            "fno3d_init": as_np(params), "fno3d_new": as_np(new),
            "fno3d_grads": as_np({"params": grads["params"]}), "fno3d_loss": float(loss)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_refs):
    return _spawn_world(tmp_path_factory.mktemp("world4"), 4, list(CASES), jax_refs)


@pytest.mark.parametrize("case", list(CASES))
def test_world4(world4, case):
    """data 2 × model 2 (``train_step_model4``: model 4): the mesh; parameters
    actually sharded; the train step against the unsharded port and JAX;
    the batch-sharded solver; the pencil FFT pair at 64² (33 columns over 2
    ranks); the pencil step; the fine-tune; the refusals (a module the port
    does not know, a second shard_params, a pencil field on the fused and
    matmul routes); FNO3d's placements against JAX's and its train steps."""
    assert world4[case] == "ok", world4[case]


@pytest.mark.parametrize("world", [4, 2])
def test_dryrun_cli(world):
    """``python -m tpu_cfd_torch.parallel.dryrun --no-cuda --world N``: every
    leg, with the pencil leg where the model axis has 2 ranks."""
    done = subprocess.run(
        [sys.executable, "-m", "tpu_cfd_torch.parallel.dryrun", "--no-cuda", "--world",
         str(world)],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=SPAWN_DEADLINE_S)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])["dryrun"]
    legs = ["train_step", "epoch", "solver", "recorded_rollout", "fused_rollout",
            *(["pencil"] if world == 4 else []), "finetune"]
    assert out["world"] == world and list(out["legs_ms"]) == legs
    assert out["mesh"] == ({"data": 2, "model": 2} if world == 4 else
                           {"data": 2, "model": 1})


def test_dryrun_leg_raises_on_a_mismatch(monkeypatch):
    """A fused rollout that drifts by 1e-3 fails its leg, so the run raises
    (and the CLI exits non-zero); the world of one is left again."""
    from tpu_cfd_torch.ops.cuda import spectral_step as ss
    from tpu_cfd_torch.parallel import dryrun

    plain = ss._fused_rollout_plain
    monkeypatch.setattr(ss, "_fused_rollout_plain",
                        lambda w, *a, **k: plain(w, *a, **k) * 1.001)
    with pytest.raises(AssertionError, match="dryrun fused aligned rollout"):
        dryrun.main(["--no-cuda"])
    assert not dist.is_initialized()


def test_dense_runs_the_hooks_of_a_sharded_layer():
    """``dense`` with a compute dtype calls a layer that has hooks (the
    gather of a sharded layer) as a module, on the cast parameters."""
    from tpu_cfd_torch.models.base import dense

    layer = torch.nn.Linear(4, 6)
    x = torch.randn(3, 4)
    want = torch.nn.functional.linear(x.bfloat16(), layer.weight.bfloat16(),
                                      layer.bias.bfloat16())
    assert torch.equal(dense(layer, x, torch.bfloat16), want)
    layer.register_forward_hook(lambda m, args, out: torch.cat([out, out], dim=-1))
    got = dense(layer, x, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, torch.cat([want, want], -1))
