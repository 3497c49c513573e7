"""Device ms a step of the image loss (``core/sharding.py``
``distributed_gs_loss``, ``core/losses.py``; layer: image loss): the
kernels under the train step's ``gs.loss`` ranges, the loss's forward (the
L1 and the SSIM's 11 x 11 window as a grouped convolution; on a mesh also
the strips' halo exchange and the sums' all-reduce, waits included), and
those under the ``ConvolutionBackward0`` autograd node, the window's
transpose. The loss's elementwise backward (the SSIM map's and the L1's
terms) runs under other autograd nodes and is left out. None when the
trace holds no device time under either."""
from gsbench.profread import node_device_ms
from gsbench.rangeread import range_device_ms

UNIT = "ms"


def read(ctx):
    ms = (range_device_ms(ctx.prof, "gs.loss") or 0.0) + node_device_ms(ctx.prof, "ConvolutionBackward0")
    return ms / ctx.steps if ms else None
