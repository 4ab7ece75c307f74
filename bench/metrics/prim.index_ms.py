"""Device milliseconds a query in ATen's index, gather and scatter kernels
(PyTorch's own, not the port's): the primitives' and operators' glue.

The kernels are named one by one: `index_elementwise_kernel` runs both
`index` and `index_put`; `elementwise_kernel_with_index`, which is
`arange`'s, is no index kernel and stays out."""

ATEN_INDEX_KERNELS = (
    "at::native::index_elementwise_kernel<",
    "at::native::_scatter_gather_elementwise_kernel<",
    "at::native::vectorized_gather_kernel<",
    "at::native::index_put_with_sort_kernel<",
    "indexSelectLargeIndex<",
    "indexSelectSmallIndex<",
    "indexFuncLargeIndex<",
    "indexFuncSmallIndex<",
)


def aten_index(name: str) -> bool:
    return any(k in name for k in ATEN_INDEX_KERNELS)


def read(ctx):
    if ctx.device is None or not ctx.completed:
        return None
    n, s = ctx.device.seconds(aten_index)
    return s * 1e3 / ctx.completed if n else None
