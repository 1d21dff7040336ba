from .sstable import SST, merge_runs
from .block_cache import BlockCache
from .tree import LSMConfig, LSMTree, MemTable
from .db import DB, ScenarioConfig, SCHEMES, SCALE

__all__ = [
    "SST", "merge_runs", "BlockCache", "LSMConfig", "LSMTree", "MemTable",
    "DB", "ScenarioConfig", "SCHEMES", "SCALE",
]
