"""The ctypes signatures the kernel wrappers bind agree with the C launchers
their sources export.

The launchers are called through ``ctypes`` with the argument types each
wrapper declares in ``_ARGTYPES``; a parameter added to or dropped from a C
launcher without the wrapper following would pass garbage on the card, and
nothing on the CPU would notice. This reads each exported signature from
``kernels/csrc/*.cu`` (a launcher written out, or the ``NAME`` of a launcher
macro and its instantiations) and compares it with the wrapper's list, so it
runs without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import importlib
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

# (wrapper module, kernel source, exported launcher)
ENTRY_POINTS = [
    ("repro_torch.kernels.decode_attn.decode_attn", "decode_attn", f"{name}_{sfx}")
    for name in ("decode_attention", "paged_decode_attention") for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.mla_decode.mla_decode", "mla_decode", f"{name}_{sfx}")
    for name in ("mla_latent_decode", "mla_paged_latent_decode") for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.ssd.ssd", "ssd_scan", f"ssd_scan_{sfx}") for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.gdn.gdn", "gdn_scan", f"gdn_scan_{sfx}") for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.ssd.ssd_bwd", "ssd_scan_bwd", f"ssd_scan_bwd_{sfx}")
    for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.gdn.gdn_bwd", "gdn_scan_bwd", f"gdn_scan_bwd_{sfx}")
    for sfx in ("f32", "bf16")
] + [
    ("repro_torch.kernels.prefill_attn.prefill_attn", "prefill_attn", "prefill_attention_bf16"),
]


def _ctype(param: str):
    """The ctypes type of one C parameter such as ``const void* q`` or ``int B``."""
    param = " ".join(param.split())
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]


def exported_signatures(source: str) -> dict:
    """{exported launcher: [ctypes type of each parameter]} of ``csrc/<source>.cu``."""
    text = CSRC.joinpath(f"{source}.cu").read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        name, params = m.group(1), m.group(2).replace("\\", " ")
        types = [_ctype(p) for p in params.split(",")]
        if name != "NAME":
            out[name] = types
            continue
        macro = re.findall(r"#define (\w+)\(NAME\b", text[:m.start()])[-1]
        for inst in re.findall(rf"^{macro}\((\w+),", text, flags=re.M):
            out[inst] = types
    return out


@pytest.mark.parametrize("module,source,launcher", ENTRY_POINTS)
def test_wrapper_argtypes_match_the_c_launcher(module, source, launcher):
    signatures = exported_signatures(source)
    assert launcher in signatures, f"csrc/{source}.cu exports no {launcher}"
    assert importlib.import_module(module)._ARGTYPES == signatures[launcher]
