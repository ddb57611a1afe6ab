"""Every CUDA kernel's ctypes binding against the C signature of its entry
point, on the CPU.

A wrapper passes its arguments through ``ctypes`` with the types its
``CudaKernel`` declares; a pointer declared as an int is cut to 32 bits and
a missing or surplus argument is found only when the kernel launches on the
card.  So each declared type list (plus the stream, a pointer) is held
against the parameter list of the ``extern "C"`` function in its source,
parameter by parameter: pointers for pointers, ints for ints, floats for
floats.
"""

import ctypes
import re

import pytest

from ir_ads_tpu_torch.ops import (
    block_tail, block_tail_int8, dscf_attention, dscf_fused, dscf_rows, dscf_rows_bwd, dscf_rpe,
    dscf_rpe_jmajor, dscf_rpe_packed, msdeform, msdeform_bwd, patch_embed, swin_block,
    swin_block_full,
    swin_block_int8, swin_block_v6, swin_block_v7, window_attention_map, window_attention_qkv,
    window_attention_v1, window_attn_bwd,
)

MODULES = (swin_block, block_tail, dscf_rpe, dscf_rows, swin_block_v6, dscf_rpe_packed,
           window_attn_bwd, dscf_rows_bwd, msdeform, swin_block_int8, block_tail_int8,
           window_attention_qkv, swin_block_v7, swin_block_full, window_attention_map,
           dscf_fused, dscf_attention, dscf_rpe_jmajor, patch_embed, window_attention_v1,
           msdeform_bwd)


def _c_parameters(source: str, fn: str):
    """The parameter types of ``extern "C" int fn(...)`` as 'ptr', 'int' or
    'float'."""
    m = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', source, re.S)
    assert m, f"no extern \"C\" int {fn}(...) in the source"
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            kinds.append("ptr")
        elif decl.startswith(("int ", "long long ")):
            kinds.append("int")
        elif decl.startswith("float "):
            kinds.append("float")
        else:
            raise AssertionError(f"{fn}: parameter {decl!r} of no known kind")
    return kinds


def _kind(ctype):
    if issubclass(ctype, ctypes._Pointer):  # a typed host array (K9's level shapes)
        return "ptr"
    return {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}[ctype]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_binding_matches_the_c_signature(mod):
    k = mod.KERNEL
    declared = [_kind(t) for t in k.argtypes] + ["ptr"]  # the stream, appended by call()
    assert declared == _c_parameters(k.source.read_text(), k.fn)


@pytest.mark.parametrize("kernel", [block_tail_int8.HIDDEN, block_tail_int8.IGEMM],
                         ids=lambda k: k.name)
def test_check_entries_match_the_c_signature(kernel):
    """The entries of K11's source that chip_smoke.py's checks call: the W1
    passes with their hidden written out, the s8 GEMM's raw output."""
    declared = [_kind(t) for t in kernel.argtypes] + ["ptr"]
    assert declared == _c_parameters(kernel.source.read_text(), kernel.fn)
