"""The share of the traced window in which no operation ran on the device,
in percent."""


def read(ctx):
    if ctx.device is None:
        return None
    return 100 * (1 - ctx.device.busy_s / ctx.device.window_s)
