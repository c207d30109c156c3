"""Host C++ for the sequential paths NumPy cannot vectorize, via ctypes.

Counterpart of ``deltapq_tpu/native``: the same source
(``dtc_native.cpp``, held byte-equal to the JAX package's by the tests)
and the same API.  ``build.get_lib`` compiles it with g++ on first use
into ``_build/native-<hash>/`` inside the package; each ``*_native``
function returns None when the library is unavailable (no g++), and
its callers then take their Python loops (``tree.layout.build_layout``,
``tree.serialize.deserialize_dtc`` / ``decode_dtc_to_codes``, the CLI's
``diff_scan``).  This is host code: no function here touches a device.
"""

from .build import get_lib, have_native
from .api import (dtc_decode_native, dtc_parse_native, dfs_layout_native,
                  scan_query_native, diff_index_decode_native)

__all__ = ["get_lib", "have_native", "dtc_decode_native",
           "dtc_parse_native", "dfs_layout_native", "scan_query_native",
           "diff_index_decode_native"]
