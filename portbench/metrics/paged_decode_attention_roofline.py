"""Kernels layer (kernel 2, ``kernels/csrc/decode_attn.cu`` through
``paged_decode_attention``): the least time its calls in the profiled
stretch could take (``counts.kernel2_call`` at each replay's live lengths,
once a layer) over the profiler's device time of the kernels this file
names, in %."""
from portbench.counts import bound_s, kernel2_call, n_layers

KERNELS = ("tc_split_kernel", "tc_combine_kernel")


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    spent = sum(s for name, s in prof["by_name"].items() if any(k in name for k in KERNELS))
    if not spent:
        return None
    cfg, layers = rec["cfg"], n_layers(rec["cfg"])
    need = sum(layers * bound_s(kernel2_call(cfg, ln, rec["block_size"]))
               for ln in prof["replay_lengths"] if len(ln))
    return need / spent * 100.0
