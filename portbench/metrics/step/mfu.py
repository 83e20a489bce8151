"""The training step's model FLOPs utilisation: the model's FLOPs a step
(`counts/<family>.py`: active experts, causal pairs, no recomputation)
times the window's steps, over the window's seconds and the bfloat16
peak, in percent."""
UNIT = "%"


def read(ctx):
    if ctx.window_steps == 0 or ctx.window_s <= 0:
        return None
    arch, mix = ctx.cell.config["arch"], ctx.cell.traffic
    flops = ctx.count(arch["family"]).step_flops(arch, mix["batch"], mix["seq"])
    return 100.0 * flops * ctx.window_steps / ctx.window_s / ctx.peaks["bf16_flops_per_s"]
