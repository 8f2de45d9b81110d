"""Persistent operator suite of the port: keyed state in the embedded,
durable KV store (``kv.py``, the log the durability plane's checkpoints
also live in).  The operators do the reference's per-input keyed
read-modify-write (``P_Map``, ``P_Filter``, ``P_FlatMap``, ``P_Reduce``,
``P_Sink``), and persistent keyed windows spill archive fragments to the
store so window state can exceed RAM.  They run on the host; a store
either package wrote reopens under the other."""

from windflow_tpu_torch.persistent.builders import (P_Filter_Builder,
                                                    P_FlatMap_Builder,
                                                    P_Keyed_Windows_Builder,
                                                    P_Map_Builder,
                                                    P_Reduce_Builder,
                                                    P_Sink_Builder)
from windflow_tpu_torch.persistent.db_handle import DBHandle
from windflow_tpu_torch.persistent.kv import LogKV, close_shared, open_shared
from windflow_tpu_torch.persistent.ops import (PFilter, PFlatMap, PMap,
                                               PReduce, PSink)
from windflow_tpu_torch.persistent.p_windows import (PKeyedWindows,
                                                     SpillingArchive)

__all__ = ["LogKV", "open_shared", "close_shared", "DBHandle", "PMap",
           "PFilter", "PFlatMap", "PReduce", "PSink", "PKeyedWindows",
           "SpillingArchive", "P_Map_Builder", "P_Filter_Builder",
           "P_FlatMap_Builder", "P_Reduce_Builder", "P_Sink_Builder",
           "P_Keyed_Windows_Builder"]
