"""The train step's share of the bf16 peak: model FLOPs a trained token
(6N + 12 L E S at the published widths, no recompute counted) times the
window's tokens/s outside the traced stretch, over 989 TFLOP/s."""

from benchmarks.harness import yardstick


def read(record):
    flops = yardstick.train_flops_per_token(record["config"],
                                            int(record["traffic"]["seq_len"]))
    return 100 * flops * record["rate"] / yardstick.PEAK_BF16_FLOPS
