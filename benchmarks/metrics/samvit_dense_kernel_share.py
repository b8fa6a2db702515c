"""Share of SAM's Dense layers that their hand-written GEMM runs, %: the
device milliseconds of the operations launched inside the program's span
``pmc.kernel.dense_gemm`` over those launched inside ``pmc.samvit.qkv``,
``pmc.samvit.out`` and ``pmc.samvit.mlp``, per forward. None where the
program opens no kernel span there (a commit before the kernel, or the
plain path)."""

from benchmarks.harness import program_spans


def read(view):
    dense = program_spans.device_ms(view, "pmc.samvit.qkv", "pmc.samvit.out",
                                    "pmc.samvit.mlp")
    kernel = program_spans.device_ms(view, "pmc.kernel.dense_gemm")
    if not dense or kernel is None:
        return None
    return 100.0 * kernel / dense
