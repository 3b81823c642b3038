"""The SASS counter of the 1-row qmm body (tools/gemv_sass.py) on a made-up
disassembly: which function it takes, which loop, and which part of the loop
it calls the math core."""

import pytest

from eagle_tpu_torch.tools.gemv_sass import issue_us, kernel_sass, step_loop


def _line(addr: int, text: str) -> str:
    return f"        /*{addr:04x}*/                   {text} ;   /* 0x0000 */\n"


def _function(name: str, body: list[str]) -> str:
    return f"Function : {name}\n" + "".join(_line(16 * i, t) for i, t in enumerate(body))


# a short loop at 0x20-0x40 and the step loop at 0x50-0xc0: copies, then the
# math core (up to the last HMMA), then the loop's bookkeeping
BODY = ["S2R R0, SR_TID.X", "ISETP.GE.AND P0, PT, R0, 0x8, PT",
        "IADD3 R1, R1, 0x1, RZ", "ISETP.NE.AND P1, PT, R1, 0x4, PT", "@P1 BRA 0x20",
        "LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64]", "LDGDEPBAR",
        "LOP3.LUT R6, R7, 0xf, RZ, 0xc0, !PT", "FFMA R8, R6, R9, -R10", "F2FP.BF16.F32.PACK_AB R11, R8, R8",
        "HMMA.16816.F32.BF16 R12, R14, R16, R12", "IADD3 R3, R3, 0x1, RZ",
        "@!P0 BRA 0x50", "EXIT"]


def test_step_loop_takes_the_longest_loop_and_its_math_core():
    loop, core = step_loop(_function("_Zqmm_gemv", BODY))
    assert sum(loop.values()) == 8  # 0x50 through the branch at 0xc0
    assert loop["LDGSTS"] == 1 and loop["BRA"] == 1
    assert core == {"LOP3": 1, "FFMA": 1, "F2FP": 1, "HMMA": 1}


def test_kernel_sass_picks_the_qmm_cu_instance():
    qmm = _function("_ZN_6_qmm_cu_qmm_gemv_kernelILi32ELb1EEEv", BODY)
    ffn = _function("_ZN_6_ffn_cu_qmm_gemv_kernelILi32ELb1EEEv", BODY[:3])
    other = _function("_ZN_6_qmm_cu_qmm_gemv_kernelILi16ELb1EEEv", BODY[:2])
    got = kernel_sass(ffn + other + qmm)
    assert got.startswith("_ZN_6_qmm_cu_qmm_gemv_kernelILi32ELb1E")
    with pytest.raises(ValueError, match="0 functions"):
        kernel_sass(ffn + other)


def test_step_loop_refuses_a_function_without_the_loop():
    with pytest.raises(ValueError, match="no backward branch"):
        step_loop(_function("f", ["S2R R0, SR_TID.X", "EXIT"]))
    with pytest.raises(ValueError, match="no asynchronous copy"):
        step_loop(_function("f", BODY[:5]))


def test_issue_us_counts_warp_steps_over_the_card():
    # wqkv: 12288 x 4096 weights, 64 a lane per step, 32 lanes a warp step,
    # 4 warp instructions a clock on each of 132 SMs
    assert issue_us(1, 1000.0) == pytest.approx(12288 * 4096 / 64 / 32 / 528 / 1000.0)
