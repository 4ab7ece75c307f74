"""The clustered gather kernel's share of its roofline in the window: the
sum of each launch's bytes bound (bench/roofline.py) over the sum of its
device times, in percent. Nothing is read where the launches counted
around the wrapper and those the device ran differ in number."""
from bench import roofline

# launch counter name -> (module, wrapper, bytes of one launch)
CAPTURE = {
    "clustered_gather": ("repro_torch.kernels.gather", "clustered_gather",
                         lambda src, idx: roofline.clustered_gather_bytes(
                             src.shape[0], idx.shape[0], src.element_size())),
}


def read(ctx):
    if ctx.device is None or ctx.launch_bytes is None:
        return None
    nbytes = ctx.launch_bytes["clustered_gather"]
    n, s = ctx.device.seconds(lambda name: "clustered_gather_kernel" in name)
    if not n or n != len(nbytes):
        return None
    return 100 * roofline.bound_s(sum(nbytes)) / s
