"""The partition kernels' share of their roofline in the window: the sum of
each launch's bytes bound (bench/roofline.py) over the sum of their device
times, in percent. Nothing is read where the launches counted around the
wrappers and those the device ran differ in number."""
from bench import roofline

KERNELS = {"block_histograms": "block_histograms_kernel",
           "partition_ranks": "partition_ranks_kernel"}
_MODULE = "repro_torch.kernels.radix_partition"
# launch counter name -> (module, wrapper, bytes of one launch)
CAPTURE = {
    "block_histograms": (_MODULE, "block_histograms",
                         lambda d, bins, tile=roofline.TILE:
                         roofline.block_histograms_bytes(d.shape[0], bins, tile)),
    "partition_ranks": (_MODULE, "rank_with_base",
                        lambda d, base, bins, tile=roofline.TILE:
                        roofline.partition_ranks_bytes(d.shape[0], bins, tile)),
}


def read(ctx):
    if ctx.device is None or ctx.launch_bytes is None:
        return None
    nbytes = [b for k in KERNELS for b in ctx.launch_bytes[k]]
    n, s = ctx.device.seconds(lambda name: any(v in name for v in KERNELS.values()))
    if not n or n != len(nbytes):
        return None
    return 100 * roofline.bound_s(sum(nbytes)) / s
