"""Share of its roofline that the ViT's attention core reaches: least
time from the model's shapes (``benchmarks/counts/vit.py``: q·kᵀ and the
weighted sum of v, with q, k, v and the output each moved once) over the
device time of the operations launched inside the program's span
``pmc.vit.attn.core``, per forward, %."""

from benchmarks.counts import vit
from benchmarks.harness import program_spans


def read(view):
    ms = program_spans.device_ms(view, "pmc.vit.attn.core")
    if not ms:
        return None
    flops, nbytes = vit.attention_core(view.dims)
    n = view.dims["n_layers"]
    least = max(n * flops / view.peaks["flops_per_s"],
                n * nbytes / view.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (ms / 1e3)
