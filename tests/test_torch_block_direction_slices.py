"""The bf16 slice route of block_direction (csrc/block_direction.cu's
block_slice_kernel) on the host: the route and slice plan that
staircase2.block_direction_route computes from the shapes, for the
relation counts of every shipped dataset and dr 1-8, and the slice
kernel's walkers (contiguous runs of merge-path sub-ranges, an L-ary
search, a sub-range closed at every multiple of ``items``) walked in
Python as the kernel walks them, against the walk of block_direction_f32
(test_torch_merge_path_kernels.block_walk): the same sums in the same
order, so the same bits, and the same carry rows. A bf16 CPU tensor takes
the plain version and moves no counter."""
import numpy as np
import pytest
import torch

from relationprediction_torch.graph import build_csr
from relationprediction_torch.ops import staircase, staircase2
from test_torch_merge_path_kernels import (LAYOUTS, N_BLOCKS, N_REL, N_SRC,
                                           DR, block_walk, walk_layout)

# Toy, wn18, FB15k-237, FB15k (data/*/relations.dict).
DATASET_RELATIONS = {"Toy": 9, "wn18": 18, "FB15k-237": 237, "FB15k": 1345}
COUNTERS = ("launches", "twin_launches", "bf16_launches",
            "bf16_twin_launches", "bf16_slice_launches",
            "bf16_twin_slice_launches", "bf16_walk_launches",
            "bf16_twin_walk_launches", "fixup_launches")


def widths(dr):
    """Block counts to plan for at dr: gcn_block.exp's d = 500 (B at most
    the kernel's 128), and a few small and odd ones."""
    return sorted({min(128, 500 // dr), 1, 3, 17, 128})


@pytest.mark.parametrize("dr", range(1, 9))
@pytest.mark.parametrize("dataset", DATASET_RELATIONS)
def test_slices_cover_every_block_once_within_the_budget(dataset, dr):
    n_rel = DATASET_RELATIONS[dataset]
    for n_blocks in widths(dr):
        plan = staircase2.block_direction_route(n_rel, n_blocks, dr)
        assert plan.route == "slice", (dataset, dr, n_blocks)
        covered = [b for first, end in plan.slices(n_blocks)
                   for b in range(first, end)]
        assert covered == list(range(n_blocks))
        assert all(first < end for first, end in plan.slices(n_blocks))
        least, most = staircase2.SLICE_LANES
        assert least <= plan.lanes <= most
        assert plan.lanes & (plan.lanes - 1) == 0
        assert 1 <= plan.blocks_per_slice <= plan.lanes
        assert plan.smem_bytes == staircase2.slice_smem_bytes(
            n_rel, plan.blocks_per_slice, dr)
        assert plan.smem_bytes <= staircase2.SLICE_SMEM_BUDGET


def test_fb15k237_plan():
    """gcn_block.exp on FB15k-237: 7 slices of at most 15 of the 100 5x5
    blocks, walkers of a half-warp, 182,016 bytes of W and 16,384 of
    staging a thread block."""
    plan = staircase2.block_direction_route(237, 100, 5)
    assert plan == staircase2.BlockRoute("slice", 15, 16, 7, 198400)
    assert plan.slices(100)[-1] == (90, 100)


@pytest.mark.parametrize("dr", range(1, 9))
def test_shapes_that_cannot_fit_take_the_walk(dr):
    """The walk exactly where a one-block slice of every relation and the
    staging exceed the budget: R * ceil((2 * dr * dr + 14) / 16) * 16
    bytes + 16 a thread."""
    staging = 16 * staircase2.slice_threads(dr)
    budget = staircase2.SLICE_SMEM_BUDGET - staging
    chunks = (2 * dr * dr + 14 + 15) // 16
    largest = budget // (16 * chunks)  # most relations a slice can hold
    for n_rel in (largest, largest + 1, 5000, 20000):
        plan = staircase2.block_direction_route(n_rel, 100, dr)
        fits = n_rel <= largest
        assert plan.route == ("slice" if fits else "walk"), (n_rel, dr)
        if not fits:
            assert plan == staircase2.BlockRoute("walk")
    assert staircase2.block_direction_route(5000, 100, 5).route == "walk"


def test_kernel_route_follows_the_dtype_and_the_shapes():
    x16 = torch.zeros(4, 500, dtype=torch.bfloat16)
    assert staircase2.kernel_route(x16, torch.zeros(
        237, 100, 5, 5, dtype=torch.bfloat16)) == "slice"
    assert staircase2.kernel_route(x16, torch.zeros(
        5000, 100, 5, 5, dtype=torch.bfloat16)) == "walk"
    assert staircase2.kernel_route(torch.zeros(4, 500), torch.zeros(
        237, 100, 5, 5)) == "walk"


@pytest.mark.parametrize("dtype, n_rel", [(torch.float32, 237),
                                          (torch.bfloat16, 5000)])
def test_launch_refuses_a_slice_route_the_plan_has_not(dtype, n_rel):
    """``route="slice"`` raises for f32 inputs and for a shape whose slice
    does not fit, before the library is touched."""
    layout, _ = build_csr([0], [0], [1], [1.0], 2)
    x = torch.zeros(2, 10, dtype=dtype)
    blocks = torch.zeros(n_rel, 2, 5, 5, dtype=dtype)
    with pytest.raises(ValueError, match="no 'slice' route"):
        staircase2.launch(None, x, blocks, layout, 2, route="slice")
    with pytest.raises(ValueError, match="no 'sideways' route"):
        staircase2.launch(None, x, blocks, layout, 2, route="sideways")


@pytest.mark.parametrize("twin", [False, True])
def test_bf16_cpu_tensor_takes_the_plain_version(twin):
    """compute_dtype bf16 on CPU tensors: the plain version on the
    bf16-rounded inputs, forward and twin pass, and no counter moves."""
    rng = np.random.default_rng(4)
    n, n_rel, n_blocks, dr = 12, 3, 4, 5
    senders = rng.integers(0, n, 40)
    receivers = rng.integers(0, n, 40)
    relations = rng.integers(0, n_rel, 40)
    weights = rng.random(40) + 0.1
    layout, order = build_csr(senders, relations, receivers, weights, n)
    twin_layout, _ = build_csr(receivers[order], relations[order],
                               senders[order], weights[order], n)
    x = torch.from_numpy(rng.standard_normal((n, n_blocks * dr))).float()
    blocks = torch.from_numpy(
        rng.standard_normal((n_rel, n_blocks, dr, dr))).float()
    before = {k: getattr(staircase2.block_direction, k) for k in COUNTERS}
    f = x.clone().requires_grad_(twin)
    out = staircase2.block_direction(f, blocks, layout, n, twin_layout,
                                     compute_dtype=torch.bfloat16)
    x16, w16 = x.to(torch.bfloat16), blocks.to(torch.bfloat16)
    want = staircase2.block_direction_reference(x16, w16, layout, n)
    assert out.dtype == torch.float32
    assert torch.equal(out, want)
    if twin:
        g = torch.from_numpy(rng.standard_normal((n, n_blocks * dr))).float()
        out.backward(g)
        want_dx = staircase2.block_direction_reference(
            g.to(torch.bfloat16), w16.transpose(-1, -2), twin_layout, n)
        assert torch.equal(f.grad, want_dx)
    assert {k: getattr(staircase2.block_direction, k)
            for k in COUNTERS} == before


def lary_rows_before(row_ptr, n_rows, n_edges, diag, lanes):
    """block_direction.cu's walker_rows_before: lane l probes p_l =
    min(lo + l * step, hi - 1), step = ceil(span / lanes); the probes
    below ``diag`` are a prefix, counted by a ballot. Returns (rows before
    diag, steps)."""
    lo, hi, steps = max(diag - n_edges, 0), min(diag, n_rows), 0
    while lo < hi:
        step = -(-(hi - lo) // lanes)
        probes = [min(lo + l * step, hi - 1) for l in range(lanes)]
        below = [row_ptr[p + 1] + p < diag for p in probes]
        c = sum(below)
        assert below == [True] * c + [False] * (lanes - c)
        if c == 0:
            hi = lo
        else:
            last_below = min(lo + (c - 1) * step, hi - 1)
            if c < lanes:
                hi = min(lo + c * step, hi - 1)
            lo = last_below + 1
        steps += 1
    return lo, steps


def slice_walk(layout, x, blocks, items, chunks, walkers, lanes):
    """What block_slice_kernel does, thread block by thread block along
    the partition and walker by walker: each walker walks its contiguous
    run of sub-ranges item by item (a row end or an entry, in merge
    order), sums z over a relation run and adds blocks[r] @ z when the run
    ends (a change of run, the row's end, a sub-range's end), writes each
    row at its end and, at every multiple of ``items``, the sub-range's
    carry; then the fix-up (carries of a row in sub-range order, then the
    partial its last sub-range wrote). The slices split the columns and
    change no sum, so all columns are walked at once here. Returns (out,
    carry_rows)."""
    src, rel, w = (t.numpy() for t in (layout.src, layout.rel, layout.w))
    rp = layout.row_ptr.tolist()
    n_rows, n_edges = len(rp) - 1, rp[-1]
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    total = n_rows + n_edges
    n_sub = -(-total // items)
    zero = np.zeros(n_blocks * dr)
    out = np.full((n_rows, n_blocks * dr), np.nan)
    carry_rows = np.full(n_sub, -2, np.int64)
    carries = {}
    keys = np.asarray(rp[1:]) + np.arange(n_rows)

    def close(z, r):
        if r is None:
            return 0
        return np.einsum("bij,bj->bi", blocks[r],
                         z.reshape(n_blocks, dr)).reshape(-1)

    per_block = -(-n_sub // chunks)
    for c in range(chunks):
        kb0 = min(c * per_block, n_sub)
        kb1 = min(kb0 + per_block, n_sub)
        per_walker = -(-(kb1 - kb0) // walkers)
        for walker in range(walkers):
            k0 = min(kb0 + walker * per_walker, kb1)
            k1 = min(k0 + per_walker, kb1)
            if k0 >= k1:
                continue
            d0, d_end = min(k0 * items, total), min(k1 * items, total)
            i, _ = lary_rows_before(rp, n_rows, n_edges, d0, lanes)
            assert i == int(np.searchsorted(keys, d0, side="left"))
            j, pos, b = d0 - i, d0, k0
            row_start = rp[i]
            row_end = rp[i + 1] if i < n_rows else np.inf
            cut = min(d0 + items, d_end)
            y, z, run = zero, zero, None
            while pos < d_end:
                if j >= row_end:  # row i ends before entry j
                    y = y + close(z, run)
                    assert np.isnan(out[i]).all()  # each row written once
                    out[i], y, z, run = y, zero, zero, None
                    row_start, i = row_end, i + 1
                    row_end = rp[i + 1] if i < n_rows else np.inf
                else:
                    if rel[j] != run:
                        y, z, run = y + close(z, run), zero, rel[j]
                    z = z + w[j] * x[src[j]]
                    j += 1
                pos += 1
                if pos == cut:  # the end of sub-range b
                    y, z, run = y + close(z, run), zero, None
                    has_carry = i < n_rows and j > row_start
                    assert carry_rows[b] == -2  # each sub-range walked once
                    carry_rows[b] = i if has_carry else -1
                    if has_carry:
                        carries[b] = y
                    else:
                        assert not np.any(y)
                    y, b, cut = zero, b + 1, min(cut + items, d_end)
    assert (carry_rows >= -1).all()
    for b, row in enumerate(carry_rows):
        if row < 0 or (b > 0 and carry_rows[b - 1] == row):
            continue
        acc, c = carries[b], b + 1
        while c < n_sub and carry_rows[c] == row:
            acc, c = acc + carries[c], c + 1
        out[row] = acc + out[row]
    return out, carry_rows


# (thread blocks along the partition, walkers a block, lanes a walker):
# one walker; several, some with no sub-range; the FB15k-237 plan's shape
# (1,024 threads as 64 walkers of 16 lanes) and that of 16 lanes above
# dr = 6 (512 threads as 32 walkers).
WALKERS = [(1, 1, 4), (3, 5, 8), (2, 64, 16), (2, 32, 16), (7, 16, 32)]


@pytest.mark.parametrize("chunks, walkers, lanes", WALKERS)
@pytest.mark.parametrize("items", [1, 7, 64])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_slice_walkers_give_the_walks_bits(kind, items, chunks, walkers,
                                           lanes):
    layout = walk_layout(kind)
    rng = np.random.default_rng(items + chunks)
    x = rng.standard_normal((N_SRC, N_BLOCKS * DR))
    blocks = rng.standard_normal((N_REL, N_BLOCKS, DR, DR))
    got, carry_rows = slice_walk(layout, x, blocks, items, chunks, walkers,
                                 lanes)
    want, _ = block_walk(layout, x, blocks, items)
    assert np.array_equal(got, want)
    assert np.array_equal(carry_rows, staircase.merge_path_carry_rows(
        layout.row_ptr, items).numpy())


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_lary_search_finds_every_diagonal(lanes):
    """The walker's search against searchsorted on a skewed CSR, at every
    diagonal, in at most ceil(log_lanes(rows)) + 1 steps."""
    rp = walk_layout("zipf").row_ptr.tolist()
    n_rows, n_edges = len(rp) - 1, rp[-1]
    keys = np.asarray(rp[1:]) + np.arange(n_rows)
    bound = int(np.ceil(np.log(n_rows + 1) / np.log(lanes))) + 1
    for diag in range(n_rows + n_edges + 1):
        got, steps = lary_rows_before(rp, n_rows, n_edges, diag, lanes)
        assert got == int(np.searchsorted(keys, diag, side="left"))
        assert steps <= bound
