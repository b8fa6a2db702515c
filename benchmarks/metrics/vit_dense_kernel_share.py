"""Share of the ViT's Dense layers that their hand-written GEMM runs, %:
the device milliseconds of the operations launched inside the program's
span ``pmc.kernel.dense_gemm`` over those launched inside ``pmc.vit.qkv``,
``pmc.vit.attn.out``, ``pmc.vit.mlp`` and ``pmc.vit.head``, per forward.
None where the program opens no kernel span there (a commit before the
kernel, or the plain path)."""

from benchmarks.harness import program_spans


def read(view):
    dense = program_spans.device_ms(view, "pmc.vit.qkv", "pmc.vit.attn.out",
                                    "pmc.vit.mlp", "pmc.vit.head")
    kernel = program_spans.device_ms(view, "pmc.kernel.dense_gemm")
    if not dense or kernel is None:
        return None
    return 100.0 * kernel / dense
