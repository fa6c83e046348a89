"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from densefusion_tpu_torch.ops import add_dist, knn, phase_conv


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nr,active", [
    (64, 500, 500, None),           # the serving path's scoring shape
    (3, 1003, 2600, [1, 0, 1]),     # ragged, > one ref tile, a gated row
])
def test_remap_kernel_matches_plain(b, nq, nr, active):
    dev = _cuda()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, nq, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((b, nr, 3))
                         .astype(np.float32)).to(dev)
    a = None if active is None else torch.tensor(active, dtype=torch.int32,
                                                 device=dev)
    kc, ks = knn.adds_remap_kernel(q, r, a)
    pc, ps = knn.adds_remap_plain(q, r, a)
    torch.cuda.synchronize()
    # the kernel rounds every score as the plain version does: exact match
    assert torch.equal(kc, pc)
    assert torch.equal(ks, ps)


@pytest.mark.cuda
def test_remap_kernel_ties_pick_lowest_index():
    dev = _cuda()
    rng = np.random.default_rng(1)
    half = rng.standard_normal((4, 300, 3)).astype(np.float32)
    r = torch.from_numpy(np.concatenate([half, half], 1)).to(dev)
    q = torch.from_numpy(rng.standard_normal((4, 700, 3))
                         .astype(np.float32)).to(dev)
    kc, _ = knn.adds_remap_kernel(q, r)
    _, idx = knn.nearest_neighbor(q, r)
    torch.cuda.synchronize()
    assert int(idx.max()) < 300
    assert torch.equal(kc, torch.gather(r, 1, idx[..., None].expand(-1, -1,
                                                                     3)))


def _remap_case(kind, rng):
    """(query, ref, active) as numpy for the remap's card cases: refs tied at
    swapped x and y (``chip_smoke.swapped_remap_problem``) at the scoring
    shape and across ref tiles, a one-sample grid, every row gated."""
    import chip_smoke

    if kind.startswith("swapped"):
        nr = 2600 if kind.endswith("tiles") else 500
        return (*chip_smoke.swapped_remap_problem(rng, 64, 500, nr), None)
    if kind == "small grid":
        return (rng.standard_normal((1, 37, 3)),
                rng.standard_normal((1, 500, 3)), None)
    return (rng.standard_normal((8, 300, 3)), rng.standard_normal((8, 700, 3)),
            np.zeros(8, np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["swapped ties", "swapped ties across tiles",
                                  "small grid", "every row gated"])
def test_remap_kernel_edge_cases_match_plain(kind):
    """A wrong tie winner moves the coordinates (x and y swap); a small grid
    splits the scan across warps; gated rows are zeros: all equal to the
    plain version."""
    dev = _cuda()
    q, r, act = _remap_case(kind, np.random.default_rng(7))
    q = torch.from_numpy(q.astype(np.float32)).to(dev)
    r = torch.from_numpy(r.astype(np.float32)).to(dev)
    a = None if act is None else torch.from_numpy(act).to(dev)
    kc, ks = knn.adds_remap_kernel(q, r, a)
    pc, ps = knn.adds_remap_plain(q, r, a)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc)
    assert torch.equal(ks, ps)
    if kind.startswith("swapped"):
        assert float((pc[..., 0] != pc[..., 1]).float().mean()) > 0.99
    if act is not None:
        assert not kc.any() and not ks.any()


@pytest.mark.cuda
def test_remap_kernel_repeats_bit_identical():
    dev = _cuda()
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((64, 500, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((64, 500, 3))
                         .astype(np.float32)).to(dev)
    first = knn.adds_remap_kernel(q, r)
    again = knn.adds_remap_kernel(q, r)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_add_dist_kernels_match_plain():
    """Both distance kernels against their plain versions and the autograd
    Function's backward on the card, with ``chip_smoke.py``'s cases and
    tolerances (phase-1 and refiner shapes, ragged, ties, batches of one
    kind, at the pose)."""
    _cuda()
    import chip_smoke

    worst = chip_smoke.check_add_dist(add_dist, np.random.default_rng(2))
    assert set(worst) == {"add_dist_paired", "add_dist_min"}


@pytest.mark.cuda
def test_paired_kernel_repeats_and_allocates_only_out():
    """The paired kernel writes ``out`` in one launch with no scratch: two
    launches on the phase-1 inputs give equal bits, a call counts one
    launch, and the wrapper's peak allocation is its (B, N, 13) output."""
    dev = _cuda()
    import chip_smoke

    args = chip_smoke.pose_problem(np.random.default_rng(6), 32, 1000, 500)
    act = (torch.arange(32, device=dev) >= 8).int()
    first = add_dist.paired_kernel(*args, act)
    torch.cuda.synchronize()
    before = add_dist.paired_kernel.launches
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    again = add_dist.paired_kernel(*args, act)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert add_dist.paired_kernel.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    out_bytes = 32 * 1000 * 13 * 4
    assert peak <= -(-out_bytes // 512) * 512


@pytest.mark.cuda
def test_nn_kernels_match_plain():
    """Kernel 3 (rank 2) and kernel 4 (batched) against their plain versions
    with ``chip_smoke.py``'s cases (the benchmark and phase-1 ADD-S shapes,
    ragged, ties, sentinel refs): indices equal, distances bit-identical."""
    _cuda()
    import chip_smoke

    worst = chip_smoke.check_nn(knn, np.random.default_rng(3))
    assert worst == {"nn": 0.0, "nn_batched": 0.0}


@pytest.mark.cuda
def test_phase_conv_kernel_matches_plain():
    """Kernel 6 against its plain version with ``chip_smoke.py``'s cases
    (the decoder's three phase convolutions at B=64, the JAX test's ragged
    shapes, B=1, the tile-edge cases) within 1e-4 of the largest element,
    and the kernel route's gradients equal to the library route's."""
    _cuda()
    import chip_smoke

    before = phase_conv.phase_conv_kernel.launches
    worst, worst_rel = chip_smoke.check_phase_conv(phase_conv,
                                                   np.random.default_rng(4))
    assert np.isfinite(worst) and worst_rel <= 1e-4
    assert phase_conv.phase_conv_kernel.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (8, 48, 48, 256, 256),    # up2's shape at B=8 (TMA weights)
    (2, 12, 10, 130, 5),      # ragged: Cout 5 takes the plain-load weights
    (1, 5, 7, 3, 9),          # tiny odd map, Cin below one wgmma depth
    (2, 12, 10, 96, 64),      # Cin 96: not a multiple of 64 (3 chunks of 32)
    (1, 3, 4, 96, 64),        # a map smaller than one tile
    (3, 7, 9, 40, 136),       # flat length no multiple of the tile, odd w,
                              # a part-filled chunk, a second channel tile
    (1, 24, 24, 1024, 1024),  # B=1 at up1's shape (bench_latency)
    (2, 96, 96, 64, 256),     # up3's shape at B=2
])
def test_phase_conv_bf16_kernel_matches_plain(b, h, w, cin, cout):
    """Kernel 6's bf16 route against its plain version (float32 sums of the
    bf16 products, one rounding) on a channels-last map: every element
    within one bf16 ulp (``chip_smoke.bf16_ulps``), bf16 out, one launch
    counted. Cin % 8 != 0 takes the plain-load input path, Cout % 8 != 0
    the plain-load weights."""
    dev = _cuda()
    import chip_smoke

    gen = torch.Generator(dev).manual_seed(7)
    xp = torch.randn((b, cin, h + 2, w + 2), device=dev,
                     generator=gen).to(torch.bfloat16).contiguous(
                         memory_format=torch.channels_last)
    pk = (torch.randn((3, 3, cin, cout), device=dev, generator=gen)
          / np.sqrt(9 * cin)).to(torch.bfloat16)
    before = phase_conv.phase_conv_bf16_kernel.launches
    got = phase_conv.phase_conv_bf16_kernel(xp, pk)
    want = phase_conv.conv3x3_valid_plain_nchw(xp, pk)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert chip_smoke.bf16_ulps(got, want) <= 1.0
    assert phase_conv.phase_conv_bf16_kernel.launches == before + 1


@pytest.mark.cuda
def test_phase_conv_bf16_kernel_misaligned_base():
    """A channels-last map whose base is 2 bytes off 16 (a view one element
    into its storage) takes the plain-load input path: within one ulp."""
    dev = _cuda()
    import chip_smoke

    gen = torch.Generator(dev).manual_seed(8)
    buf = torch.randn((2 * 10 * 12 * 16 + 1,), device=dev,
                      generator=gen).to(torch.bfloat16)
    xp = buf[1:].view(2, 10, 12, 16).permute(0, 3, 1, 2)
    pk = (torch.randn((3, 3, 16, 32), device=dev, generator=gen)
          / 12).to(torch.bfloat16)
    got = phase_conv.phase_conv_bf16_kernel(xp, pk)
    want = phase_conv.conv3x3_valid_plain_nchw(xp, pk)
    torch.cuda.synchronize()
    assert xp.data_ptr() % 16 == 2
    assert chip_smoke.bf16_ulps(got, want) <= 1.0


@pytest.mark.cuda
def test_phase_conv_bf16_kernel_refuses_nchw_map():
    """The bf16 kernel takes a channels-last map only: an NCHW-contiguous
    bf16 map on the card raises, in the wrapper and through the kernel
    route, and nothing launches or converts it silently."""
    dev = _cuda()
    xp = torch.zeros((2, 16, 10, 12), device=dev, dtype=torch.bfloat16)
    pk = torch.zeros((3, 3, 16, 32), device=dev, dtype=torch.bfloat16)
    before = phase_conv.phase_conv_bf16_kernel.launches
    with pytest.raises(ValueError, match="channels-last"):
        phase_conv.phase_conv_bf16_kernel(xp, pk)
    with pytest.raises(ValueError, match="channels-last"):
        phase_conv.conv3x3_valid_nchw(xp, pk, "kernel")
    assert phase_conv.phase_conv_bf16_kernel.launches == before


@pytest.mark.cuda
def test_knn_ties_lowest_index_first_on_card():
    """``knn(k=3)`` on CUDA tensors against 150 refs duplicated: the exact
    ties come lowest index first, as the JAX ``knn`` orders them."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 200, 3))
                         .astype(np.float32)).to(dev)
    half = rng.standard_normal((2, 150, 3)).astype(np.float32)
    r = torch.from_numpy(np.concatenate([half, half], axis=1)).to(dev)
    d, i = knn.knn(q, r, k=3)
    torch.cuda.synchronize()
    assert d.shape == i.shape == (2, 200, 3) and i.dtype == torch.int64
    tied = d[..., 0] == d[..., 1]
    assert float(tied.float().mean()) > 0.9
    assert bool((i[..., 0][tied] < i[..., 1][tied]).all())
    assert bool((i[..., 0] < 150).all())


@pytest.mark.cuda
def test_segnet_step_on_card_matches_cpu():
    """A narrow SegNet's train step on the card against the CPU (TF32 off):
    in float64 the gradients and BN statistics within 1e-6 of each
    tensor's largest (float32 gradients move with near-ties that pool or
    gate the other way; ``examples/segnet_grad_precision.py``); in float32
    the loss rel 1e-4; the argmax pool of one map equal on both."""
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.models.layers import max_pool_argmax
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    dev = _cuda()
    enc = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))
    dec = ((16, 16, 16), (16, 16, 16), (16, 16, 12), (12, 8), (8,))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)))
    label = torch.from_numpy(rng.integers(0, 5, (2, 64, 64)))
    out = {}
    for d in ("cpu", dev):
        for dtype in (torch.float32, torch.float64):
            state = create_seg_train_state(SegNet(5, enc, dec), seed=3,
                                           device=d)
            state.segnet.to(dtype)
            loss = make_seg_train_step(state)(x.to(d, dtype), label.to(d))
            net = state.segnet
            out[str(d), dtype] = (
                float(loss),
                {n: p.grad.cpu().double() for n, p in net.named_parameters()
                 if not (n.startswith("conv") and n.endswith("bias")
                         and n != "conv11d.bias")},
                {n: v.cpu().double() for n, v in net.state_dict().items()
                 if "running" in n})
    cpu, card = out["cpu", torch.float64], out["cuda", torch.float64]
    assert abs(card[0] - cpu[0]) <= 1e-9 * abs(cpu[0])
    for got, want in ((card[1], cpu[1]), (card[2], cpu[2])):
        for k, v in want.items():
            assert float((got[k] - v).abs().max()) <= \
                1e-6 * float(v.abs().max()), k
    f32 = out["cuda", torch.float32][0], out["cpu", torch.float32][0]
    assert abs(f32[0] - f32[1]) <= 1e-4 * abs(f32[1])
    m = torch.relu(torch.from_numpy(rng.standard_normal((2, 8, 32, 32))
                                    .astype(np.float32)))
    p_cpu, i_cpu = max_pool_argmax(m)
    p_card, i_card = max_pool_argmax(m.to(dev))
    assert torch.equal(i_cpu, i_card.cpu()) and torch.equal(
        p_cpu, p_card.cpu())


def _one_rank_mesh():
    """A one-rank NCCL mesh in this process (torn down by the caller)."""
    from densefusion_tpu_torch.parallel import make_mesh

    return make_mesh(1)


def _dp_batch(rng, b=4, n=32, m=32, crop=32, num_obj=2):
    from densefusion_tpu_torch.data import PoseSample

    return PoseSample(
        points=(rng.standard_normal((b, n, 3)) * 0.05 + [0, 0, 0.6])
        .astype(np.float32),
        choose=rng.integers(0, crop * crop, (b, n)).astype(np.int32),
        img=rng.standard_normal((b, crop, crop, 3)).astype(np.float32),
        target=(rng.standard_normal((b, m, 3)) * 0.05).astype(np.float32),
        model_points=(rng.standard_normal((b, m, 3)) * 0.05)
        .astype(np.float32),
        obj_idx=rng.integers(0, num_obj, (b,)).astype(np.int32),
        sym=np.arange(b) == 0, valid=np.arange(b) < b // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [1, 2])
def test_one_rank_nccl_dp_step_equals_one_device_step(phase):
    """The data-parallel phase-1 and phase-2 steps on a one-rank NCCL mesh
    against the one-device steps, each from the same seeded state (dropout
    on, half the rows invalid): loss, ``dis`` and every parameter after the
    step within 1e-6 of each tensor's largest element, the gradients within
    1e-5. The card's float32 backward is not bit-reproducible (cuDNN's
    backward and the gathers' scatter-adds sum with atomics): the
    one-device step taken again differs from the first by up to ~2e-6 of a
    tensor's largest gradient, and that figure is reported beside."""
    import torch.distributed as dist

    from densefusion_tpu_torch.data import to_device
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.parallel import make_shard_batch_fn
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step, make_refine_train_step,
    )

    dev = _cuda()
    batch = to_device(_dp_batch(np.random.default_rng(3)), dev)
    try:
        sharding = make_shard_batch_fn(_one_rank_mesh()).sharding
        runs = []
        for sh in (None, None, sharding):
            state = create_train_state(PoseNet(2), PoseRefineNet(2), 1e-3, 0,
                                       dev)
            module = state.posenet if phase == 1 else state.refiner
            step = (make_pose_train_step(state, True, 1, sh) if phase == 1
                    else make_refine_train_step(state, 2, 1, sh))
            m = step(batch, 0.015)
            runs.append(([float(m["loss"]), float(m["dis"])],
                         {k: p.grad.clone()
                          for k, p in module.named_parameters()},
                         {k: v.clone() for k, v in
                          module.state_dict().items()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    def rel(got, want):
        return {k: float((got[k] - v).abs().max())
                / float(v.abs().max().clamp_min(1e-30))
                for k, v in want.items()}

    (m1, g1, p1), (_, g_again, _), (m2, g2, p2) = runs
    repeat = max(rel(g_again, g1).values())
    print(f"phase {phase}: the one-device step repeated, gradients within "
          f"{repeat:.3g} of each tensor's largest")
    np.testing.assert_allclose(m2, m1, rtol=1e-6)
    for k, err in rel(g2, g1).items():
        assert err <= 1e-5, (k, err, f"one-device repeat {repeat:.3g}")
    for k, err in rel(p2, p1).items():
        assert err <= 1e-6, (k, err)


@pytest.mark.cuda
def test_mesh_estimator_equals_meshless_on_card():
    """``PoseEstimator(mesh=)`` on a one-rank NCCL mesh, 3 samples, against
    the meshless estimator on the same weights: the same poses."""
    import torch.distributed as dist

    from densefusion_tpu_torch.data import PoseSample
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.models.init import (
        init_posenet_, init_refiner_,
    )
    from densefusion_tpu_torch.serve import PoseEstimator

    dev = _cuda()
    batch = _dp_batch(np.random.default_rng(4), b=3)
    samples = [PoseSample(*(x[i] for x in batch)) for i in range(3)]
    gen = torch.Generator().manual_seed(0)
    pose, ref = PoseNet(2), PoseRefineNet(2)
    init_posenet_(pose, gen)
    init_refiner_(ref, gen)
    states = pose.state_dict(), ref.state_dict()
    try:
        got = {name: PoseEstimator(
            PoseNet(2), PoseRefineNet(2), *states, num_points=32,
            crop_size=32, device=dev, mesh=mesh).estimate_batch(samples)
            for name, mesh in (("single", None), ("mesh", _one_rank_mesh()))}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for g, w in zip(got["mesh"], got["single"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_registered_op_launches_the_kernel_and_exports(dtype):
    """On CUDA tensors the registered op is the wrapper of the operands'
    type (one launch, the wrapper's output bit for bit), and a decoder
    stage exported on the card holds it as one node whose call launches
    the kernel once."""
    from densefusion_tpu_torch.models import layers

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 32, 12, 10), device=dev, generator=gen).to(dtype)
    w = (0.1 * torch.randn((16, 32, 3, 3), device=dev, generator=gen))
    bias = torch.randn((16,), device=dev, generator=gen)
    xp = phase_conv.replicate_pad(x, "kernel")
    pk = layers.phase_conv_weight(w.to(dtype))
    kernel = phase_conv.KERNELS[dtype]
    before = kernel.launches
    got = torch.ops.densefusion_tpu_torch.phase_conv3x3(xp, pk)
    assert kernel.launches == before + 1
    assert torch.equal(got, kernel(xp, pk.contiguous()))

    class Stage(torch.nn.Module):
        def forward(self, x):
            return layers.phase_upsample_conv3x3(x, w, bias, border="zero",
                                                 conv_backend="kernel")

    program = torch.export.export(Stage(), (x,))
    op = torch.ops.densefusion_tpu_torch.phase_conv3x3.default
    assert sum(n.target == op for n in program.graph.nodes) == 1
    before = kernel.launches
    out = program.module()(x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(out, Stage()(x))
