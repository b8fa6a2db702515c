"""Share of its roofline that SAM's global attention cores reach: least
time from the model's shapes (``benchmarks/counts/samvit.py``: q·kᵀ, the
product with v and the two relative-position einsums of every real
query, with the real tokens' q, k, v and output moved once and the
tables) over the device time of the operations launched inside the
program's span ``pmc.samvit.attn.global``, per forward, %."""

from benchmarks.counts import samvit
from benchmarks.harness import program_spans

KIND = "global"


def read(view):
    ms = program_spans.device_ms(view, f"pmc.samvit.attn.{KIND}")
    if not ms:
        return None
    flops, nbytes = samvit.attention_core(view.dims, KIND)
    n = samvit.kinds(view.dims)[KIND]
    least = max(n * flops / view.peaks["flops_per_s"],
                n * nbytes / view.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (ms / 1e3)
