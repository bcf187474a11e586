"""Data-pipeline tour through the PyTorch port: RecordIO, sharded splits,
shuffle, prefetch, cache.

Twin of ``examples/data_pipeline.py`` on ``dmlc_tpu_torch``: the IO
layer on its own (no model, no device) — the port's stream/split/record
stack (reference: include/dmlc/io.h, include/dmlc/recordio.h,
src/io/*):

  1. write a multi-part RecordIO dataset (magic-escape framing)
  2. read it back sharded: every part_index sees a disjoint, complete
     slice of records regardless of how record boundaries straddle the
     byte-range cuts
  3. shuffled split: chunk-level shuffle with a derandomizable seed
  4. threaded split: background chunk prefetch (ThreadedIter semantics)
  5. #cache URIs: first pass writes a local replay cache

Run from anywhere with the repo on ``PYTHONPATH``; it prints what the
reference's example prints.
"""

import os

import numpy as np

from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.input_split_shuffle import InputSplitShuffle
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.io.threaded_split import ThreadedInputSplit


def main() -> None:
    rng = np.random.RandomState(0)
    with TemporaryDirectory() as tmp:
        # 1. multi-part RecordIO dataset
        paths = []
        payloads = []
        for part in range(3):
            p = os.path.join(tmp.path, f"data.part{part}.rec")
            paths.append(p)
            with create_stream(p, "w") as s:
                w = RecordIOWriter(s)
                for _ in range(200):
                    rec = rng.bytes(rng.randint(100, 3000))
                    payloads.append(rec)
                    w.write_record(rec)
        uri = ";".join(paths)

        # 2. sharded read: 4 workers, disjoint + complete
        seen = []
        for k in range(4):
            sp = InputSplit.create(uri, k, 4, "recordio")
            n = 0
            for rec in sp:
                seen.append(bytes(rec))
                n += 1
            print(f"worker {k}: {n} records")
        assert sorted(seen) == sorted(payloads), "coverage/no-overlap broken"

        # 3. chunk-shuffled split (same seed -> same order)
        a = [bytes(r) for r in InputSplitShuffle.create(
            uri, 0, 1, "recordio", num_shuffle_parts=8, seed=7)]
        b = [bytes(r) for r in InputSplitShuffle.create(
            uri, 0, 1, "recordio", num_shuffle_parts=8, seed=7)]
        assert a == b and sorted(a) == sorted(payloads)
        print(f"shuffled split: deterministic order of {len(a)} records")

        # 4. background prefetch wrapper
        sp = ThreadedInputSplit(InputSplit.create(uri, 0, 1, "recordio"))
        n = sum(1 for _ in sp)
        sp.destroy()
        print(f"threaded split: {n} records prefetched on a reader thread")

        # 5. cache URI: replay from local cache on the second pass
        cache = os.path.join(tmp.path, "replay.cache")
        for _ in range(2):
            sp = InputSplit.create(f"{paths[0]}#{cache}", 0, 1, "recordio")
            sum(1 for _ in sp)
        # cache entries are shard-namespaced (.pK-N), committed through
        # the page store with a fingerprint stamp beside them
        print(f"cached split: cache file exists="
              f"{os.path.exists(cache + '.p0-1')}")


if __name__ == "__main__":
    main()
