"""The SFNO, spectral-step, Adam and IMEX-2 kernels on the card against their plain versions.

Imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py`` on a machine
with a card. Everywhere else each test skips. Tolerance: max abs error
within 1e-5 of the plain version's largest entry (one launch, fp32 sums in
another order); gradients of the whole SFNO within 1e-4 of each leaf's; the
FFN with bfloat16 rows within one bfloat16 spacing (2^-7) of the largest
entry, as kernel and plain version each round a float32 sum once; ``adam_step``
and the multi-tensor ``adam_step_leaves`` within 1e-6 of the largest entry of
each of p, m, v over three steps. The IMEX-2 step's kernels
(``imex_spectral``) equal the composed path bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch import models as tm
from tpu_cfd_torch.models.fused_conv import _dft2d_constants, make_dft2d_ops
from tpu_cfd_torch.ops.cuda import adam as tadam
from tpu_cfd_torch.ops.cuda import ffn as tffn
from tpu_cfd_torch.ops.cuda import imex_spectral as im
from tpu_cfd_torch.ops.cuda import spectral_conv as sc
from tpu_cfd_torch.ops.cuda import spectral_step as ss
from tpu_cfd_torch.solvers import equations as teq, forcings as tforcings

pytestmark = pytest.mark.cuda


def _rel_err(got, want) -> float:
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@contextlib.contextmanager
def _plain_versions():
    """The kernels' wrappers routed to their plain versions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, "modes", sc._modes_plain)
        mp.setattr(sc, "inverse", sc._inverse_plain)
        mp.setattr(tffn, "ffn_forward", tffn._ffn_plain)
        yield


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_cuda_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [16, 64, 96])  # 96: a ragged second tile
def test_dft_kernels_match_plain(dev, n):
    """modes/inverse kernels vs plain, forward and backward (each the other's)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    modes, inverse = make_dft2d_ops(n, n, 8, 8, dev)
    v = torch.randn(3, 5, n, n, device=dev, generator=gen)
    outs, grads = [], []
    sc.reset_launch_counts()
    for route in (contextlib.nullcontext(), _plain_versions()):
        with route:
            x = v.clone().requires_grad_(True)
            g = modes(x)
            y = inverse(g * (1 + 0.5j), 1.0 / (n * n))
            (y * v).sum().backward()
        outs.append(torch.cat([torch.view_as_real(g).flatten(), y.flatten()]))
        grads.append(x.grad)
    torch.cuda.synchronize()
    # each shape fits in shared memory, so every launch is fused
    assert sc.fused_modes_layout(n, n, 16, 16) is not None
    assert sc.fused_inverse_layout(n, n, 16, 16) is not None
    assert sc.LAUNCHES == {"modes": 2, "modes_fused": 2, "inverse": 2, "inverse_fused": 2}
    assert _rel_err(outs[0], outs[1]) < 1e-5
    assert _rel_err(grads[0], grads[1]) < 1e-5


# (n, m, b, planes): small, the recipe's 64^2 at m = 32, the sweep's at m = 12,
# and 96^2 at m = 20, just over the shared-memory budget: two passes
@pytest.mark.parametrize("n,m,b,planes,fused", [
    (16, 8, 2, 3, True), (64, 32, 2, 50, True), (64, 12, 4, 200, True),
    (96, 20, 2, 5, False)])
def test_modes_route_matches_plain(dev, n, m, b, planes, fused):
    """modes forward, and as inverse's backward, vs plain, on the route the
    shape picks."""
    assert (sc.fused_modes_layout(n, n, 2 * m, 2 * m) is not None) == fused
    gen = torch.Generator(device=dev).manual_seed(6)
    _, inverse = make_dft2d_ops(n, n, m, m, dev)
    c = _dft2d_constants(n, n, m, m, str(dev), "complex64")
    v = torch.randn(b, planes, n, n, device=dev, generator=gen)
    g = torch.randn(b, planes, 2 * m, 2 * m, dtype=torch.complex64, device=dev,
                    generator=gen)
    sc.reset_launch_counts()
    got = sc.modes(v, c)
    x = g.clone().requires_grad_(True)
    inverse(x, 0.5 / (n * n)).backward(v)   # backward: modes(0.5/n^2 v)
    torch.cuda.synchronize()
    inverse_fused = sc.fused_inverse_layout(n, n, 2 * m, 2 * m) is not None
    assert sc.LAUNCHES == {"modes": 2, "modes_fused": 2 * fused, "inverse": 1,
                           "inverse_fused": int(inverse_fused)}
    assert _rel_err(got, sc._modes_plain(v, c)) < 1e-5
    with _plain_versions():
        y = g.clone().requires_grad_(True)
        inverse(y, 0.5 / (n * n)).backward(v)
    assert _rel_err(x.grad, y.grad) < 1e-5
    # an offset view (not 16-byte aligned) takes the same route
    flat = torch.randn(b * planes * n * n + 1, device=dev, generator=gen)
    w = flat[1:].view(b, planes, n, n)
    assert _rel_err(sc.modes(w, c), sc._modes_plain(w, c)) < 1e-5


# (n, m, b, planes): small, the recipe's 64^2 at m = 32, the sweep's at
# m = 12, and 256^2, which takes the two passes
@pytest.mark.parametrize("n,m,b,planes,fused", [
    (16, 8, 2, 3, True), (64, 32, 2, 50, True), (64, 12, 4, 200, True),
    (256, 32, 1, 5, False)])
def test_inverse_route_matches_plain(dev, n, m, b, planes, fused):
    """inverse forward, and as modes' backward, vs plain, on the route the
    shape picks; the modes are random, not Hermitian."""
    assert (sc.fused_inverse_layout(n, n, 2 * m, 2 * m) is not None) == fused
    gen = torch.Generator(device=dev).manual_seed(8)
    modes, _ = make_dft2d_ops(n, n, m, m, dev)
    c = _dft2d_constants(n, n, m, m, str(dev), "complex64")
    v = torch.randn(b, planes, n, n, device=dev, generator=gen)
    g = torch.randn(b, planes, 2 * m, 2 * m, dtype=torch.complex64, device=dev,
                    generator=gen)
    sc.reset_launch_counts()
    got = sc.inverse(g, 0.5 / (n * n), c)
    x = v.clone().requires_grad_(True)
    modes(x).backward(g)   # backward: inverse(g, 1)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["inverse"] == 2 and sc.LAUNCHES["inverse_fused"] == 2 * fused
    assert _rel_err(got, sc._inverse_plain(g, 0.5 / (n * n), c)) < 1e-5
    with _plain_versions():
        y = v.clone().requires_grad_(True)
        modes(y).backward(g)
    assert _rel_err(x.grad, y.grad) < 1e-5
    # an offset view (not 16-byte aligned) takes the same route
    flat = torch.randn(2 * g.numel() + 2, device=dev, generator=gen)
    h = torch.view_as_complex(flat[2:].view(*g.shape, 2))
    assert h.data_ptr() % 16
    assert _rel_err(sc.inverse(h, 1.0, c), sc._inverse_plain(h, 1.0, c)) < 1e-5


# the dry run's 16^2, 64^2 (the solver sweep's smallest size), 128^2 at the
# fine-tune demo's b=4, 256^2 (at an odd batch too, a partial wave of K1's
# blocks), 512^2, 1024^2 and 2048^2, both layouts: K1 and K2 at each radix of
# their last pass (16, 2, 4, 8, 16, 2, 4, 8) and at one to three passes
@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n,b", [(16, 3), (32, 3), (64, 2), (128, 4), (256, 2), (256, 3),
                                 (512, 1), (1024, 1), (2048, 1)])
def test_spectral_step_kernels_match_plain(dev, layout, n, b):
    """K1, K2 and K3 of the RK4-CN stage vs their plain versions, one launch
    each, at every K1 and K2 instance: every n the kernels take."""
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    gen = torch.Generator(device=dev).manual_seed(9)
    c = ss.constants(layout, grid, 1e-3, 0.1, 1e-3, dev)
    R, m = c["R"], c["m"]
    c["forcing"] = torch.randn(R, m, dtype=torch.complex64, device=dev, generator=gen)
    w = torch.randn(b, R, m, dtype=torch.complex64, device=dev, generator=gen)
    h = torch.randn(b, R, m, dtype=torch.complex64, device=dev, generator=gen)
    jc = ss.resolve_block_cols("auto", n, m)
    ss.reset_launch_counts()
    A = ss.inverse_first(w, c)
    assert _rel_err(A, ss._inverse_first_plain(w, c)) < 1e-5
    T = ss.advect(A, c, jc)
    assert _rel_err(T, ss._advect_plain(A, c)) < 1e-5
    for k in (0, 3):
        want = ss._forward_first_plain(T, w, h, c, k)
        got = ss.forward_first(T, w.clone(), h.clone(), c, k)
        for g_, w_ in zip(got, want):
            assert _rel_err(g_, w_) < 1e-5
    torch.cuda.synchronize()
    assert ss.LAUNCHES == {"inverse_first": 1, "advect": 1, "forward_first": 2}


@pytest.mark.parametrize("act", sorted(tffn.ACTIVATIONS))
def test_ffn_kernel_matches_plain(dev, act):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = 2 * torch.randn(3, 7, 13, 10, device=dev, generator=gen)  # 273 rows
    w1, b1 = 0.5 * torch.randn(40, 10, device=dev, generator=gen), torch.randn(40, device=dev)
    w2, b2 = 0.3 * torch.randn(10, 40, device=dev, generator=gen), torch.randn(10, device=dev)
    tffn.reset_launch_counts()
    got = tffn.pointwise_ffn(x, w1, b1, w2, b2, act)
    with _plain_versions():
        want = tffn.pointwise_ffn(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    assert tffn.LAUNCHES["ffn"] == 1
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("k,h", [(10, 40), (20, 80)])
def test_ffn_kernel_bf16_rows_match_plain(dev, k, h):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (2 * torch.randn(3, 7, 13, k, device=dev, generator=gen)).bfloat16()
    w1, b1 = 0.5 * torch.randn(h, k, device=dev, generator=gen), torch.randn(h, device=dev)
    w2, b2 = 0.3 * torch.randn(k, h, device=dev, generator=gen), torch.randn(k, device=dev)
    tffn.reset_launch_counts()
    got = tffn.pointwise_ffn(x, w1, b1, w2, b2, "GELU")
    with _plain_versions():
        want = tffn.pointwise_ffn(x, w1, b1, w2, b2, "GELU")
    torch.cuda.synchronize()
    assert tffn.LAUNCHES["ffn"] == 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel_err(got.float(), want.float()) <= 2.0 ** -7


# K and K_out in {4, 10, 20, 64}, apart and equal; H a multiple of 8 and not
@pytest.mark.parametrize("k,h,k_out", [(4, 16, 4), (10, 40, 10), (20, 80, 20),
                                       (64, 100, 64), (10, 37, 20), (64, 36, 4),
                                       (4, 12, 64)])
@pytest.mark.parametrize("rows", [1, 17, 1000])  # none a multiple of 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_kernel_shapes_match_plain(dev, k, h, k_out, rows, dtype):
    gen = torch.Generator(device=dev).manual_seed(k * h + rows)
    x = (2 * torch.randn(rows, k, device=dev, generator=gen)).to(dtype)
    w1, b1 = 0.5 * torch.randn(h, k, device=dev, generator=gen), torch.randn(h, device=dev)
    w2 = 0.3 * torch.randn(k_out, h, device=dev, generator=gen)
    b2 = torch.randn(k_out, device=dev)
    tffn.reset_launch_counts()
    got = tffn.ffn_forward(x, w1, b1, w2, b2, "GELU")
    want = tffn._ffn_plain(x, w1, b1, w2, b2, "GELU")
    torch.cuda.synchronize()
    assert tffn.LAUNCHES["ffn"] == 1
    assert got.dtype == want.dtype == dtype and got.shape == (rows, k_out)
    assert _rel_err(got.float(), want.float()) <= (
        1e-5 if dtype == torch.float32 else 2.0 ** -7)


def test_ffn_kernel_at_the_fno_recipes_shape(dev):
    """The FNO recipe's instance (``train --example fno``: b=4, 64², 10
    latent steps, width 20): 163,840 float32 rows, 20 → 80 → 20, GELU, one
    launch, within 1e-5 of the plain version's largest entry."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(4 * 64 * 64 * 10, 20, device=dev, generator=gen)
    w1, b1 = 0.3 * torch.randn(80, 20, device=dev, generator=gen), torch.randn(80, device=dev)
    w2, b2 = 0.15 * torch.randn(20, 80, device=dev, generator=gen), torch.randn(20, device=dev)
    tffn.reset_launch_counts()
    got = tffn.ffn_forward(x, w1, b1, w2, b2, "GELU")
    want = tffn._ffn_plain(x, w1, b1, w2, b2, "GELU")
    torch.cuda.synchronize()
    assert tffn.LAUNCHES["ffn"] == 1 and got.shape == (163_840, 20)
    assert _rel_err(got, want) <= 1e-5


def test_ffn_kernel_takes_rows_that_are_not_16_byte_aligned(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn(1 + 300 * 10, device=dev, generator=gen)
    x = buf[1:].view(300, 10)
    assert x.data_ptr() % 16
    w1, b1 = 0.5 * torch.randn(40, 10, device=dev, generator=gen), torch.randn(40, device=dev)
    w2, b2 = 0.3 * torch.randn(10, 40, device=dev, generator=gen), torch.randn(10, device=dev)
    got = tffn.ffn_forward(x, w1, b1, w2, b2, "ReLU")
    assert _rel_err(got, tffn._ffn_plain(x, w1, b1, w2, b2, "ReLU")) < 1e-5


@pytest.mark.parametrize("offset", [0, 1])  # 1: no pointer is 16-byte aligned
@pytest.mark.parametrize("n", [1, 3, 10, 4097, 1_024_000])
def test_adam_kernel_matches_plain(dev, n, offset):
    gen = torch.Generator(device=dev).manual_seed(4)
    p, g, m, v = (torch.randn(n + offset, device=dev, generator=gen)[offset:]
                  for _ in range(4))
    v = v.square_()
    ref = [t.clone() for t in (p, m, v)]
    tadam.reset_launch_counts()
    for step in (1, 2, 3):
        tadam.adam_step(p, g, m, v, lr=1e-3, step=step)
        tadam._adam_plain(ref[0], g, ref[1], ref[2], 1e-3, 0.9, 0.999, 1e-8, step)
    torch.cuda.synchronize()
    assert tadam.LAUNCHES["adam"] == 3
    for name, got, want in zip("pmv", (p, m, v), ref):
        assert _rel_err(got, want) < 1e-6, name


def _adam_case(dev, sizes_offsets, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = []
    for n, off in sizes_offsets:
        p, g, m, v = (torch.randn(n + off, device=dev, generator=gen)[off:]
                      for _ in range(4))
        state.append((p, g, m, v.square_()))
    return state


@pytest.mark.parametrize("table", [False, True])  # adam_step_leaves, AdamLeaves
@pytest.mark.parametrize("leaves", [8, 130])       # one launch; three
def test_adam_leaves_kernel_matches_plain(dev, leaves, table):
    """Mixed sizes (empty, odd, a multiple of the chunk, 1,024,000), aligned
    and offset-1 views, in one list; exact launch and leaf counts."""
    sizes = [0, 1, 3, 10, 4097, 16384, 1_024_000, 400]
    cases = [(sizes[i % len(sizes)], i % 2) for i in range(leaves)]
    state = _adam_case(dev, cases, leaves)
    ref = [[t.clone() for t in (p, m, v)] for p, _, m, v in state]
    ps, gs, ms, vs = (list(ts) for ts in zip(*state))
    kept = tadam.AdamLeaves(ps, ms, vs) if table else None
    tadam.reset_launch_counts()
    for step in (1, 2, 3):
        if table:
            kept.step(gs, lr=1e-3, step=step)
        else:
            tadam.adam_step_leaves(ps, gs, ms, vs, lr=1e-3, step=step)
        for (p, m, v), g in zip(ref, gs):
            tadam._adam_plain(p, g, m, v, 1e-3, 0.9, 0.999, 1e-8, step)
    torch.cuda.synchronize()
    nonempty = sum(n > 0 for n, _ in cases)
    assert tadam.LAUNCHES == {"adam": 3 * -(-nonempty // tadam.MAX_LEAVES),
                              "adam_leaves": 3 * nonempty}
    for i, ((p, _, m, v), want) in enumerate(zip(state, ref)):
        for name, got, w in zip("pmv", (p, m, v), want):
            if w.numel():
                assert _rel_err(got, w) < 1e-6, (i, name)


def test_adam_leaves_refuse_moved_storage(dev):
    p, g, m, v = _adam_case(dev, [(100, 0)], 7)[0]
    q = torch.nn.Parameter(p.clone())
    leaves = tadam.AdamLeaves([q], [m], [v])
    q.data = p.clone()  # what model.to() does
    with pytest.raises(ValueError, match="storage moved"):
        leaves.step([g], lr=1e-3, step=1)


def test_adam_kernel_matches_torch_optim(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    p = torch.randn(20, 20, 12, 12, 5, 2, device=dev, generator=gen)
    q = torch.nn.Parameter(p.clone())
    opt = torch.optim.Adam([q], lr=1e-3)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for step in (1, 2, 3):
        g = torch.randn(p.shape, device=dev, generator=gen)
        tadam.adam_step(p, g, m, v, lr=1e-3, step=step)
        q.grad = g
        opt.step()
    assert _rel_err(p, q) < 1e-6
    assert _rel_err(m, opt.state[q]["exp_avg"]) < 1e-6
    assert _rel_err(v, opt.state[q]["exp_avg_sq"]) < 1e-6


def test_sfno_kernel_route_matches_plain(dev):
    """The small SFNO through the kernels vs through their plain versions."""
    model = tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=4, num_spectral_layers=3,
                    activation="GELU")
    tm.init_like_flax(model, torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(2, 16, 16, 10, device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(2))
    outs, grads = [], []
    for route in (contextlib.nullcontext(), _plain_versions()):
        model.zero_grad()
        with route:
            out = model(x)
            out.square().sum().backward()
        outs.append(out)
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert _rel_err(outs[0], outs[1]) < 1e-5
    for k in grads[0]:
        assert _rel_err(grads[0][k], grads[1][k]) < 1e-4, k


def test_kernels_launch_on_their_tensors_card():
    """The FFN and K2 on cuda:1 while cuda:0 is current: each launch goes to
    the card of its tensors (a ``<<<>>>`` launch goes to the current one),
    and the FFN's launch plan and K2's shared-memory attribute hold on each
    card. The FFN runs on cuda:0 first, so its plan exists there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.cuda.device(0):
        for d in (torch.device("cuda", 0), torch.device("cuda", 1)):
            gen = torch.Generator(device=d).manual_seed(3)
            x = torch.randn(4096, 20, device=d, generator=gen)
            w = [torch.randn(*s, device=d, generator=gen) * a for s, a in (
                ((80, 20), 0.3), ((80,), 0.1), ((20, 80), 0.15), ((20,), 0.1))]
            got = tffn.ffn_forward(x, *w, "GELU")
            assert got.device == d
            assert _rel_err(got, tffn._ffn_plain(x, *w, "GELU")) < 1e-5
        d1 = torch.device("cuda", 1)
        grid = grids.Grid((256, 256), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
        c = ss.constants("galerkin", grid, 1e-3, 0.1, 1e-3, d1)
        gen = torch.Generator(device=d1).manual_seed(4)
        w = torch.randn(2, c["R"], c["m"], dtype=torch.complex64, device=d1, generator=gen)
        A = ss._inverse_first_plain(w, c)
        T = ss.advect(A, c, ss.resolve_block_cols("auto", 256, c["m"]))
        torch.cuda.synchronize(d1)
        assert T.device == d1 and torch.cuda.current_device() == 0
        assert _rel_err(T, ss._advect_plain(A, c)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("k,h,act", [(10, 40, "GELU"), (20, 80, "ReLU")])
def test_ffn_kernel_on_megatron_shards(dev, k, h, act, model_parallel, dtype):
    """The FFN kernel on each rank's hidden units, as ``parallel.shard_params``
    splits a PointwiseFFN (the recipe's and the sweep's widths): each shard
    within 1e-5 (bf16 rows: 2^-7) of its plain version's largest entry, and
    the shards' sum plus the second bias within 1e-5 of the unsharded
    kernel's (bf16: half a spacing, 2^-8, of each of the mp + 1 values that
    round)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4099, k, device=dev, generator=gen).to(dtype)
    w1, b1, w2, b2 = (torch.randn(*s, device=dev, generator=gen) * a for s, a in (
        ((h, k), 0.3), ((h,), 0.1), ((k, h), 0.15), ((k,), 0.1)))
    zero, hs = torch.zeros(k, device=dev), h // model_parallel
    tffn.reset_launch_counts()
    full = tffn.ffn_forward(x, w1, b1, w2, b2, act).float()
    parts = []
    for r in range(model_parallel):
        cols = slice(r * hs, (r + 1) * hs)
        shard = (w1[cols].contiguous(), b1[cols].contiguous(), w2[:, cols].contiguous())
        got = tffn.ffn_forward(x, *shard[:2], shard[2], zero, act).float()
        want = tffn._ffn_plain(x, *shard[:2], shard[2], zero, act).float()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert _rel_err(got, want) <= tol
        parts.append(got)
    assert tffn.LAUNCHES["ffn"] == 1 + model_parallel
    total = torch.stack(parts).sum(0) + b2
    err = float((total - full).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * float(full.abs().max())
    else:
        assert err <= 2.0 ** -8 * (sum(float(p.abs().max()) for p in parts)
                                   + float(total.abs().max()) + float(full.abs().max()))


def test_tensor_parallel_sfno_at_world_1_on_nccl(dev, tmp_path):
    """A small SFNO through ``shard_params`` with every shardable leaf on a
    model axis of one rank (NCCL): the collectives run, each sharded layer
    launches its kernels as the unsharded model does, and two train steps
    match the unsharded ones (rtol 1e-5, atol 1e-6); then the dry run."""
    import copy

    import torch.distributed as dist

    from tpu_cfd_torch import parallel
    from tpu_cfd_torch.parallel import dryrun
    from tpu_cfd_torch.train import losses

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        ref = tm.init_like_flax(tm.SFNO(modes_x=8, modes_y=8, modes_t=3, width=8,
                                        num_spectral_layers=3, activation="GELU"),
                                torch.Generator().manual_seed(0)).to(dev)
        tp = parallel.shard_params(copy.deepcopy(ref), mesh,
                                   spec_fn=lambda k, p, m: parallel.sfno_layout(k, p, 1))
        gen = torch.Generator(device=dev).manual_seed(6)
        v, y = (torch.randn(2, 32, 32, 10, device=dev, generator=gen) for _ in range(2))
        loss_obj = losses.SobolevLoss(n_grid=32, norm_order=-1, relative=True)
        counts = []
        for model in (tp, ref):
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            sc.reset_launch_counts()
            tffn.reset_launch_counts()
            for _ in range(2):
                opt.zero_grad()
                loss_obj(model(v), y).backward()
                parallel.average_gradients(model.parameters(), mesh)
                opt.step()
            counts.append({**sc.LAUNCHES, **tffn.LAUNCHES})
        assert counts[0] == counts[1] and counts[0]["ffn"] == 6 and counts[0]["modes_fused"]
        got = parallel.gather_parameters(tp)
        for k, p in ref.named_parameters():
            torch.testing.assert_close(got[k], p.detach(), rtol=1e-5, atol=1e-6, msg=k)
        out = dryrun.run(dev, log=lambda line: None)
        assert out["mesh"] == {"data": 1, "model": 1} and "fused_rollout" in out["legs_ms"]
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_fno3d_at_world_1_on_nccl(dev, tmp_path):
    """A small FNO3d through ``shard_params`` with every leaf on a model axis
    of one rank (NCCL): one train step matches the unsharded one (rtol 1e-5,
    atol 1e-6) and neither launches a kernel (its convs take ``torch.fft``,
    its MLPs are ``nn.Linear``)."""
    import copy

    import torch.distributed as dist

    from tpu_cfd_torch import parallel
    from tpu_cfd_torch.train import losses

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        ref = tm.init_like_flax(tm.FNO3d(8, 8, 3, 8, input_channel=4),
                                torch.Generator().manual_seed(0)).to(dev)
        tp = parallel.shard_params(copy.deepcopy(ref), mesh,
                                   spec_fn=lambda k, p, m: parallel.sfno_layout(k, p, 1))
        gen = torch.Generator(device=dev).manual_seed(7)
        x = tm.make_fno3d_input(torch.randn(2, 32, 32, 4, device=dev, generator=gen), 6)
        y = torch.randn(2, 32, 32, 6, device=dev, generator=gen)
        loss_obj = losses.SobolevLoss(n_grid=32, norm_order=0, relative=True)
        for model in (tp, ref):
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            sc.reset_launch_counts()
            tffn.reset_launch_counts()
            loss_obj(model(x)[0], y).backward()
            parallel.average_gradients(model.parameters(), mesh)
            opt.step()
            assert not any({**sc.LAUNCHES, **tffn.LAUNCHES}.values())
        got = parallel.gather_parameters(tp)
        for k, p in ref.named_parameters():
            torch.testing.assert_close(got[k], p.detach(), rtol=1e-5, atol=1e-6, msg=k)
    finally:
        dist.destroy_process_group()


# -- the IMEX-2 step's kernels (ops/cuda/imex_spectral.py) ------------------
# Kernel and composed path compute the same IEEE operations in the same order
# (the .cu header), so they are held equal bit for bit, signs of zeros too.

def _imex_solver(dev, dtype, n=256, **kw):
    """The FNO dataset's solver: forced on the vorticity, the 2/3 rule, IMEX-2."""
    grid = grids.Grid((n, n), domain=((0, 1.0), (0, 1.0)))
    forcing = tforcings.SinCosForcing(grid=grid, scale=0.1, diam=1.0, wave_number=1,
                                      vorticity=True)
    kw.setdefault("fft_impl", "fft")
    return teq.NavierStokes2DSpectral(viscosity=1e-3, grid=grid, smooth=True,
                                      forcing_fn=forcing, solver=teq.IMEXStepper(order=2),
                                      dtype=dtype, device=dev, **kw)


def _imex_state(dev, dtype, lead, n=256, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.fft.rfft2(torch.randn((*lead, n, n), dtype=dtype, device=dev, generator=gen))


def _bitwise_equal(got, want) -> bool:
    def bits(t):
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)

    return got.shape == want.shape and torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("lead", [(4,), (2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_imex_spectral_explicit_terms_equal_composed(dev, dtype, lead):
    ns = _imex_solver(dev, dtype)
    w = _imex_state(dev, dtype, lead)
    im.reset_launch_counts()
    got = ns.explicit_terms(w)
    assert im.LAUNCHES == {"spectra": 1, "advect": 1, "finish": 1, "rk2_cn_stage": 0}
    want = ns._explicit_terms(w)
    assert torch.equal(got, want), _rel_err(got, want)
    assert _bitwise_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_imex_spectral_step_equals_composed(dev, dtype):
    """One IMEX-2 step at 256², b=4 on the kernels against the composed path,
    and its launches: two of each kernel."""
    ns = _imex_solver(dev, dtype)
    w = _imex_state(dev, dtype, (4,), seed=6)
    im.reset_launch_counts()
    got = ns.solver(w, 1e-3, ns)
    assert im.LAUNCHES == {"spectra": 2, "advect": 2, "finish": 2, "rk2_cn_stage": 2}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ns, "_kernel_takes", lambda u: False)
        want = ns.solver(w, 1e-3, ns)
    assert im.LAUNCHES["spectra"] == 2  # the composed path launches none
    assert torch.equal(got, want), _rel_err(got, want)
    assert _bitwise_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_imex_spectral_kernels_equal_plain(dev, dtype):
    """Each kernel against its plain version on the same CUDA tensors."""
    ns = _imex_solver(dev, dtype)
    c = ns._kernel_constants()
    w = _imex_state(dev, dtype, (3,), seed=7)
    specs = im.spectra(w, c)
    assert _bitwise_equal(specs, im._spectra_plain(w, c))
    planes = torch.fft.irfft2(specs, s=ns.grid.shape, norm="forward")
    adv = im.advect(planes, c)
    assert _bitwise_equal(adv, im._advect_plain(planes, c))
    terms = torch.fft.rfft2(adv)
    want = im._finish_plain(terms, c)
    assert _bitwise_equal(im.finish(terms, c), want)
    h, f = want, ns._explicit_terms(2 * w)
    for second in (None, f):
        assert _bitwise_equal(im.rk2_cn_stage(w, h, second, c, 1e-3, 0.5, 0.5),
                              im._rk2_cn_stage_plain(w, h, second, c, 1e-3, 0.5, 0.5))


def test_imex_spectral_other_routes_launch_none(dev):
    """The matmul layouts, a gradient and a complex128 spectrum in an fp32
    solver take the composed path on the card."""
    im.reset_launch_counts()
    for fft_impl in ("dft", "dft_aligned", "dft_galerkin"):
        ns = _imex_solver(dev, torch.float32, n=64, fft_impl=fft_impl)
        ns.forward(_imex_state(dev, torch.float32, (2,), n=64), 1e-3, steps=2)
    ns = _imex_solver(dev, torch.float32, n=64)
    w = _imex_state(dev, torch.float32, (2,), n=64).requires_grad_(True)
    ns.explicit_terms(w).abs().sum().backward()
    assert w.grad is not None
    ns.explicit_terms(_imex_state(dev, torch.float64, (2,), n=64))
    assert not any(im.LAUNCHES.values()), im.LAUNCHES
