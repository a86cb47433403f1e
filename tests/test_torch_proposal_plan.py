"""The launch plans of the proposal kernels (K1, K6, K8 and their bf16
variants), mirrored in ``ops/proposal_cuda.py`` from
csrc/proposal_rows.cu::vml_proposal_plan, checked on the CPU at the three
shipped maps and at the narrow TINY / ODD geometry of the card tests, for both
dtypes: every plan fits the shared memory of one H100 block (and an SM holds
the blocks the plan counts on), the blocks' columns cover D, a bf16 warp
access is one row segment of 128 bytes (backward) or 256 bytes (forward)
wherever D allows it, the fp32 plan is unchanged, the bf16 backward's ring gives each
slot one consumer, and the T each kernel admits. The card test ``test_proposal_plan_matches_the_library``
in tests/test_torch_cuda.py holds the mirror to the C entry.
"""

import pytest
import torch

from video_moment_localization_tpu_torch.ops import proposal_cuda
from video_moment_localization_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES

BF16 = torch.bfloat16
SM_SMEM, RESERVED = 233472, 1024   # one H100 SM's shared memory, reserved per block
# (T, L, C, D): the shipped maps at D=512, TINY (D=64) and ODD (D=30).
GEOMETRIES = {"charades": (64, 16, 4, 512), "activitynet": (128, 64, 4, 512),
              "tacos": (128, 32, 4, 512), "tiny": (16, 8, 4, 64), "odd": (10, 5, 3, 30)}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_plan_fits_a_block_and_covers_d(geo, backward, dtype):
    T, L, C, D = GEOMETRIES[geo]
    plan = proposal_cuda.plan(T, L, C, backward, dtype)
    assert 0 < plan["smem"] <= MAX_SMEM_BYTES
    assert 1 <= plan["warps"] <= 32
    tiles = -(-D // plan["cols"])
    assert tiles * plan["cols"] >= D > (tiles - 1) * plan["cols"]
    if dtype == BF16 and backward:
        assert plan["blocks_per_sm"] in (1, 2)
        # the blocks an SM the plan counts on fit it, reserve included
        assert plan["blocks_per_sm"] * (plan["smem"] + RESERVED) <= SM_SMEM
        # a producer warp beside the consumers, whose number divides the
        # slots' (each slot has one consumer), two slots a consumer at least
        consumers = plan["warps"] - 1
        assert 1 <= consumers and plan["slots"] % consumers == 0
        assert 2 * consumers <= plan["slots"] <= 32
    else:
        assert plan["slots"] == 0


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_bf16_warp_accesses_are_full_row_segments(geo):
    """A bf16 backward lane owns two adjacent columns of a 64-column block
    and a forward lane four of a 128-column block: every full tile's warp
    access is 32 x 4 bytes (backward) or 32 x 8 bytes (forward) of one row,
    a ragged last tile (D not a multiple of the block's columns) narrower;
    the vector path needs D % 8 == 0, which every shipped map and TINY have
    and ODD lacks."""
    T, L, C, D = GEOMETRIES[geo]
    for backward, segment in ((True, 128), (False, 256)):
        plan = proposal_cuda.plan(T, L, C, backward, BF16)
        assert plan["cols"] * 2 == segment
        widths = [min(plan["cols"], D - t * plan["cols"]) * 2
                  for t in range(-(-D // plan["cols"]))]
        assert all(w == segment for w in widths[:-1])
        if D % plan["cols"] == 0:
            assert widths[-1] == segment
    assert (D % 8 == 0) == (geo != "odd")
    x = torch.zeros(4, D, dtype=BF16)
    assert proposal_cuda.vector_path(D, [x]) == (D % 8 == 0)


def test_fp32_plan_is_unchanged():
    """The fp32 kernels keep their plan: 32 columns a block, 8 forward
    warps, a backward of 8 warps at Charades (two blocks an SM) and 12 at
    ActivityNet."""
    assert proposal_cuda.backward_warps(64, 16) == 8
    assert proposal_cuda.backward_warps(128, 64) == 12
    for T, L, C, _ in GEOMETRIES.values():
        fwd = proposal_cuda.plan(T, L, C, False)
        bwd = proposal_cuda.plan(T, L, C, True)
        assert fwd == dict(warps=8, cols=32, blocks_per_sm=0,
                           smem=proposal_cuda.proposal_smem_bytes(T, L, False), slots=0)
        assert bwd == dict(warps=proposal_cuda.backward_warps(T, L), cols=32, blocks_per_sm=0,
                           smem=proposal_cuda.proposal_smem_bytes(T, L, True), slots=0)


def test_bf16_plans_at_the_shipped_maps():
    """The bf16 backward: four consumer warps, each with a T x 64 difference
    array, and a producer at every shipped map; two blocks an SM with 8
    slots each at Charades (T=64), one block with 12 at ActivityNet and 16 at
    TACoS (T=128; a slot holds the 8 x 5 rows of 128 bytes of a chunk at
    C=4); the forward: eight warps
    and a (T + 1) x 128 fp32 prefix tile."""
    assert proposal_cuda.pair_plan(64, 16, 4)[:3] == (4, 8, 2)
    assert proposal_cuda.pair_plan(128, 64, 4)[:3] == (4, 12, 1)
    assert proposal_cuda.pair_plan(128, 32, 4)[:3] == (4, 16, 1)
    assert proposal_cuda.plan(128, 64, 4, True, BF16)["warps"] == 5
    assert proposal_cuda.plan(128, 64, 4, False, BF16) == dict(
        warps=8, cols=128, blocks_per_sm=0, smem=129 * 128 * 4 + 8 * 32 * 16, slots=0)


@pytest.mark.parametrize("dtype,backward,T_max", [(torch.float32, False, 899),
                                                   (torch.float32, True, 1763),
                                                   (BF16, False, 445), (BF16, True, 837)])
def test_admission_at_l16(dtype, backward, T_max):
    """The T each kernel admits at L=16 and C=4 (the module docstring's)."""
    proposal_cuda.check_smem("k", T_max, 16, 4, backward, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        proposal_cuda.check_smem("k", T_max + 1, 16, 4, backward, dtype)
