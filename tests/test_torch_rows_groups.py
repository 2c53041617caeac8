"""SHB23's grouped row kernels (`csrc/fused_rows.cuh`): the shapes the
wrapper gives them, checked on the CPU in milliseconds, and on the card
the ptxas report of their instances.

  * the forward's group partition: every row of a launch in exactly one
    group, every operator row of a group in exactly one of its CTAs, the
    groups' CTAs on the card's SMs and at least min(G, R) CTAs a group
    (CTA j of a group forms its row j's J), for mg 128 .. 640, R 1 .. 8
    and each G of ROW_GROUPS (1, 2), on an H100 SXM (132 SMs) and PCIe
    (114);
  * the most rows a forward launch takes (`fwd_rows_most`);
  * the choice of G for each R (`fwd_row_group`, `bwd_row_group`: the
    smallest G that fits the card's SMs, or its clusters in one wave,
    else the largest whose cluster the card can schedule);
  * the register and shared-memory budget of every instance the wrapper
    can choose: the operator's floats a thread keeps plus the state it
    holds at once within 255 registers, shared memory within the H100's
    227 KB opt-in;
  * the Python mirrors of the kernels' constants against the sources.

The card case (`requires_cuda`):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_rows_groups.py

asserts that ptxas reports 0 spill bytes for every instance of the two
kernels.
"""

import re

import pytest
import torch

from spheremanopt_torch.ops.cuda import build as kbuild
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk

MGS = (128, 256, 384, 512, 640)
H100_PCIE = (114, 227 * 1024)
CARDS = {"sxm": fk.H100_SXM, "pcie": H100_PCIE}
REGISTERS = 255   # a thread's most on an H100


@pytest.mark.parametrize("card", CARDS, ids=list(CARDS))
@pytest.mark.parametrize("mg", MGS)
def test_fwd_row_groups_partition_covers_rows_and_operator_rows(mg, card):
    sms = CARDS[card][0]
    for R in range(1, fk.ROWS_MAX + 1):
        for G in fk.ROW_GROUPS:
            groups, ctas, rows = fk.fwd_rows_groups(mg, R, G, sms)
            # rows [q G, min((q + 1) G, R)) of group q: each row in one group
            members = [list(range(q * G, min((q + 1) * G, R))) for q in range(groups)]
            assert sorted(r for m in members for r in m) == list(range(R))
            assert all(members), (R, G)
            # CTA c of a group: rows [c rows, min((c + 1) rows, mg)) of A and B
            owned = [r for c in range(ctas) for r in range(c * rows, min((c + 1) * rows, mg))]
            assert owned == list(range(mg)), (R, G)
            assert (ctas - 1) * rows < mg and groups * ctas <= sms, (R, G)
            if fk.fwd_rows_fits(mg, R, G, sms):
                assert ctas >= min(G, R) and -(-rows // 8) <= fk.fwd_row_slots(mg, G)
        if R <= fk.fwd_rows_most(mg, CARDS[card]):
            G = fk.fwd_row_group(R, mg, CARDS[card])
            assert fk.fwd_rows_fits(mg, R, G, sms), R
        else:
            with pytest.raises(ValueError, match="no row group"):
                fk.fwd_row_group(R, mg, CARDS[card])
    # a launch's rows: 8 on an H100 SXM; on a PCIe card 7 where no G of
    # ROW_GROUPS fits 8 (mg 256 and 512), so 8 rows take two launches
    most = fk.fwd_rows_most(mg, CARDS[card])
    assert most == (7 if card == "pcie" and mg in (256, 512) else fk.ROWS_MAX)
    assert fk._row_chunks(8, most) == ([(0, 8)] if most == 8 else [(0, 7), (7, 8)])


def test_row_group_choice():
    """G of each row count: the forward's smallest G that fits the card
    (1 on an H100 SXM at every width, 2 at mg = 640 and R = 8 on a PCIe
    card, whose 14-CTA groups would hold 46 rows a CTA); the reverse's
    smallest G whose clusters run in one wave on the card's capacity, else
    the largest G the card can schedule; none raises."""
    assert fk.ROW_GROUPS == (1, 2)
    for R in range(1, fk.ROWS_MAX + 1):
        for mg in MGS:
            assert fk.fwd_row_group(R, mg) == 1, (R, mg)
        assert fk.bwd_row_group(R, {1: 7, 2: 7}) == (1 if R <= 7 else 2)
        assert fk.bwd_row_group(R, {1: 3, 2: 3}) == (1 if R <= 3 else 2)
        assert fk.bwd_row_group(R, {1: 7, 2: 0}) == 1
        assert fk.bwd_row_group(R, {1: -1, 2: 4}) == 2
        with pytest.raises(RuntimeError, match="can be scheduled"):
            fk.bwd_row_group(R, {1: 0, 2: -8})
    assert fk.fwd_row_group(8, 640, H100_PCIE) == 2
    assert fk.fwd_row_group(7, 640, H100_PCIE) == 1
    for bad in (0, fk.ROWS_MAX + 1):
        with pytest.raises(ValueError, match="row launch takes"):
            fk.fwd_row_group(bad, 512)
        with pytest.raises(ValueError, match="row launch takes"):
            fk.bwd_row_group(bad, {1: 7, 2: 7})


@pytest.mark.parametrize("mg", MGS)
def test_row_kernel_budgets(mg):
    """Registers and shared memory of every (mg, G, split) instance: the
    forward's operator float4s (8 mg / 128 floats a register slot) plus a
    k-step's state (u and g of G rows, 8 G floats) and its sums (slots x
    G); the reverse's two chains' register terms plus G sums of each and G
    lambdas. Shared memory of every partition the wrapper can launch."""
    nk = mg // 128
    for G in fk.ROW_GROUPS:
        regs, slots = fk.fwd_reg_slots(mg, G), fk.fwd_row_slots(mg, G)
        assert 8 * nk * regs <= fk.OP_FLOATS
        assert 8 * nk * regs + 8 * G + slots * G <= REGISTERS, G
        for R in range(1, fk.ROWS_MAX + 1):
            for card in CARDS.values():
                if fk.fwd_rows_fits(mg, R, G, card[0]):
                    rows = fk.fwd_rows_groups(mg, R, G, card[0])[2]
                    assert fk.fwd_rows_smem_bytes(mg, G, rows) <= card[1], (R, G)
        terms, chain = fk.bwd_reg_terms(mg), -(-mg // fk.row_phases(mg))
        assert terms <= fk.OP_TERMS and (terms == chain or terms % 4 == 0)
        assert 2 * terms + 3 * G <= REGISTERS, G
        assert fk.bwd_rows_smem_bytes(mg, G) <= fk.H100_SXM[1], G
    # only mg = 640 keeps part of the forward's operators in shared memory,
    # mg = 512 and 640 part of the reverse's
    assert (fk.fwd_reg_slots(mg, 1) < fk.fwd_row_slots(mg, 1)) == (mg == 640)
    assert (fk.bwd_reg_terms(mg) < -(-mg // fk.row_phases(mg))) == (mg >= 512)


def test_row_constants_mirror_the_sources():
    src = (kbuild.CSRC / "fused_rows.cuh").read_text()
    assert re.search(r"constexpr int kOpFloats = (\d+);", src).group(1) == str(fk.OP_FLOATS)
    assert re.search(r"constexpr int kOpTerms = (\d+);", src).group(1) == str(fk.OP_TERMS)
    assert "kClusterCtas" in src
    two = (kbuild.CSRC / "fused_two_matrix.cu").read_text()
    cases = re.findall(r"case (\d+): return f\(smo::fused_fwd_rows_g(\d+),", two)
    assert [int(g) for g, h in cases if g == h] == list(fk.ROW_GROUPS)
    for G in fk.ROW_GROUPS:
        assert f"SMO_ROWS_DEFINE({G})" in (kbuild.CSRC / f"fused_rows_g{G}.cu").read_text()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_row_kernels_spill_nothing_on_card(cuda):
    """ptxas's report of the library's build: every instance of the two
    row kernels (5 widths x 2 G each, 20 in all) spills 0 bytes."""
    kbuild.load()
    report = [r for r in kbuild.ptxas_report()
              if "fused_fwd_rows_kernel" in r[0] or "fused_bwd_rows_kernel" in r[0]]
    assert len(report) == 2 * len(MGS) * len(fk.ROW_GROUPS) == 20, report
    bad = [r for r in report if r[2] != 0 or r[3] != 0]
    assert not bad, bad
