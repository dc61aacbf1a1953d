"""The adaptive models under the JAX package's import path
(``compressjs_tpu.models``): re-exports of ``host``."""

from ..host.context1_model import Context1Model
from ..host.deflate_distance_model import DeflateDistanceModel
from ..host.defsum_model import DefSumModel
from ..host.fenwick_model import FenwickModel
from ..host.log_distance_model import LogDistanceModel
from ..host.mtf_model import MTFModel
from ..host.no_model import NoModel

__all__ = ['Context1Model', 'DefSumModel', 'DeflateDistanceModel',
           'FenwickModel', 'LogDistanceModel', 'MTFModel', 'NoModel']
