"""Share of the Transolver's projections that their fused kernel runs, %:
the device milliseconds of the operations launched inside the program's
span ``pmc.kernel.projection_conv`` over those launched inside
``pmc.attn.project``, per forward. None where the program opens no
kernel span there (a commit before the kernel, or the plain path)."""

from benchmarks.harness import program_spans


def read(view):
    project = program_spans.device_ms(view, "pmc.attn.project")
    kernel = program_spans.device_ms(view, "pmc.kernel.projection_conv")
    if not project or kernel is None:
        return None
    return 100.0 * kernel / project
