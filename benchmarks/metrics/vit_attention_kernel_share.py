"""Share of the ViT's attention core that its fused kernel runs, %: the
device milliseconds of the operations launched inside the program's span
``pmc.kernel.dense_attention`` over those launched inside
``pmc.vit.attn.core``, per forward. None where the program opens no
kernel span there (a commit before the kernel, or the plain path)."""

from benchmarks.harness import program_spans


def read(view):
    core = program_spans.device_ms(view, "pmc.vit.attn.core")
    kernel = program_spans.device_ms(view, "pmc.kernel.dense_attention")
    if not core or kernel is None:
        return None
    return 100.0 * kernel / core
