"""TSV table reader with column selection + shard-path expansion.

The port's copy of ``one_peace_tpu/data/tsv.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``).

Behavioral spec: ref one_peace/data/tsv_reader.py:6-35 (header row, tab
separator, selected_cols by name) and tasks/base_task.py:112-125 (paths
containing ``[0-9]`` expand to every existing numbered shard; comma
separates multiple datasets).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class TSVReader:
    def __init__(self, file_path: str, selected_cols: Optional[str] = None,
                 separator: str = "\t"):
        with open(file_path, encoding="utf-8") as fp:
            headers = fp.readline().rstrip("\n").split(separator)
            if selected_cols is not None:
                col_ids = [headers.index(v) for v in selected_cols.split(",")]
            else:
                col_ids = list(range(len(headers)))
            self.contents: List[List[str]] = []
            for row in fp:
                cols = row.rstrip("\n").split(separator, len(headers) - 1)
                self.contents.append([cols[i] for i in col_ids])

    def __len__(self):
        return len(self.contents)

    def __getitem__(self, index):
        return self.contents[index]


class ConcatReader:
    """Multiple shards presented as one table."""

    def __init__(self, readers: Sequence[TSVReader]):
        self.readers = list(readers)
        self.offsets = []
        total = 0
        for r in self.readers:
            self.offsets.append(total)
            total += len(r)
        self.total = total

    def __len__(self):
        return self.total

    def __getitem__(self, index):
        for reader, off in zip(reversed(self.readers), reversed(self.offsets)):
            if index >= off:
                return reader[index - off]
        raise IndexError(index)


def expand_paths(spec: str) -> List[str]:
    """ref tasks/base_task.py:112-125: comma-separated entries; an entry
    containing ``[0-9]`` globs over existing numeric shards."""
    paths: List[str] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "[0-9]" in entry:
            i = 0
            while True:
                candidate = entry.replace("[0-9]", str(i))
                if not os.path.exists(candidate):
                    break
                paths.append(candidate)
                i += 1
        else:
            paths.append(entry)
    return paths


def load_tables(spec: str, selected_cols: Optional[str] = None,
                separator: str = "\t") -> ConcatReader:
    return ConcatReader([TSVReader(p, selected_cols, separator)
                         for p in expand_paths(spec)])
