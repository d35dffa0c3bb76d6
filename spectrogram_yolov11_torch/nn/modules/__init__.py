from .block import C2PSA, SPPF, Bottleneck, C3k, C3k2  # noqa: F401
from .conv import Concat, Conv, DWConv, Upsample  # noqa: F401
from .fork import HCoordAtt  # noqa: F401
from .head import Detect  # noqa: F401
