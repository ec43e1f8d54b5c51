"""How ``experiments/sass_diff.py`` names kernels and pairs two trees' kernels.

The tool itself needs nvcc and cuobjdump (the chip machine's toolkit); its
naming and pairing are plain string work, checked here on demangled names as
``cu++filt`` prints them.
"""

import pytest

from protstruc_tpu_torch.experiments.sass_diff import key, pair

BF16 = "__nv_bfloat16"


@pytest.mark.parametrize("dem, want", [
    (f"void wide_gate_kernel<{BF16}, 2, true>(WideGateArgs<{BF16}>)", f"wide_gate_kernel<{BF16}, 2, true>"),
    (f"void (anonymous namespace)::wgrad_kernel<float, (bool)0>(WgradArgs<float>, Plan)",
     "wgrad_kernel<float, false>"),
    # an overload on the rows' dtype, templated on a flag alone
    (f"void prologue_bwd_resident_kernel<(bool)1>(RowArgs<{BF16}>, Plan)",
     f"prologue_bwd_resident_kernel<{BF16}, true>"),
    # an explicit specialization on the dtype keeps its one argument
    (f"void prologue_bwd_resident_kernel<{BF16}>(RowArgs<{BF16}>, Plan)",
     f"prologue_bwd_resident_kernel<{BF16}>"),
    ("ps_tri_route", "ps_tri_route"),
])
def test_key_names_a_kernel_as_in_its_source(dem, want):
    assert key(dem) == want


def test_pair_holds_a_flagged_build_to_the_kernel_it_replaced():
    old = dict.fromkeys([f"prologue_fwd_resident_kernel<{BF16}>", "wgrad_kernel<float, false>",
                         "flash_fwd_kernel<float, 128>", "gone_kernel<float>"])
    new = dict.fromkeys([f"prologue_fwd_resident_kernel<{BF16}, false>",
                         f"prologue_fwd_resident_kernel<{BF16}, true>", "wgrad_kernel<float, false>",
                         "wgrad_kernel<float, true>", "flash_fwd_kernel<float, 128>",
                         "flash_fwd_kernel<float, 256>"])
    held, fresh = pair(old, new)
    assert held == {f"prologue_fwd_resident_kernel<{BF16}, false>": f"prologue_fwd_resident_kernel<{BF16}>",
                    "wgrad_kernel<float, false>": "wgrad_kernel<float, false>",
                    "flash_fwd_kernel<float, 128>": "flash_fwd_kernel<float, 128>"}
    assert sorted(fresh) == sorted([f"prologue_fwd_resident_kernel<{BF16}, true>", "wgrad_kernel<float, true>",
                                    "flash_fwd_kernel<float, 256>"])
    # two copies of one commit: every kernel held to itself
    assert pair(new, new) == ({k: k for k in new}, [])
