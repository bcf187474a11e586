"""Device-resident ingest via the cuda:// URI scheme.

Twin of ``examples/tpu_device_ingest.py`` on ``dmlc_tpu_torch``: the
north-star path end to end (BASELINE.json: "Stream/SeekStream gain a
device URI that DMAs RecordIO chunks straight to device", with the CUDA
card in the TPU's place):

1. write a RecordIO dataset (records containing aligned magic bytes, so
   the escape framing is exercised),
2. stream it into device memory as raw chunks
   (``CUDASeekStream.device_chunks``: reads into reused page-locked
   buffers, async copies on a side stream with a lookahead window),
3. ingest it sharded as record batches straight to the device
   (``recordio_device_batches``: the native engine's record arenas
   copied to the device), and reduce over the payload on the device.

Runs on the CUDA card; ``--device cpu`` runs it on the host. There is
no fallback: without a card and without ``--device cpu`` it fails. It
prints what the reference's example prints, its shard count in devices
(up to 4 cards, one part each; one part on the host).
"""

import argparse
import os
import struct

import numpy as np
import torch

from dmlc_tpu_torch.io.cuda_fs import recordio_device_batches
from dmlc_tpu_torch.io.recordio import RECORDIO_MAGIC, RecordIOWriter
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
from dmlc_tpu_torch.io.tempdir import TemporaryDirectory


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    if not devices:
        raise RuntimeError("cuda_device_ingest: no CUDA card "
                           "(pass --device cpu to run on the host)")

    with TemporaryDirectory() as tmp:
        path = os.path.join(tmp.path, "dmlc_tpu_torch_example.rec")
        rng = np.random.RandomState(0)
        magic = struct.pack("<I", RECORDIO_MAGIC)
        records = []
        with open(path, "wb") as fh:
            w = RecordIOWriter(fh)
            for i in range(500):
                rec = (magic * 2 + rng.bytes(rng.randint(10, 400))
                       if i % 9 == 0 else rng.bytes(rng.randint(1, 2000)))
                records.append(rec)
                w.write_record(rec)
        print(f"wrote {len(records)} records "
              f"({os.path.getsize(path) / 1e6:.1f} MB, "
              f"{w.escaped_magic_count} escaped magics)")

        # --- raw device chunks through the cuda:// stream
        s = create_seek_stream_for_read(f"cuda://{path}")
        total = 0
        nchunks = 0
        for chunk in s.device_chunks(chunk_bytes=256 * 1024, lookahead=2,
                                     device=devices[0]):
            assert chunk.device.type == device.type
            total += chunk.numel()
            nchunks += 1
        s.close()
        print(f"device_chunks: {nchunks} chunks, {total} bytes on "
              f"{device.type}")

        # --- sharded record batches straight to the device + reduce there
        ndev = min(4, len(devices))
        checksum = 0  # host-side accumulation: the per-part sums live on
        nrec = 0      # different devices
        for part in range(ndev):
            dev = devices[part]
            for batch in recordio_device_batches(f"cuda://{path}", part,
                                                 ndev, device=dev):
                payload, starts, ends = (batch["payload"], batch["starts"],
                                         batch["ends"])
                nrec += int(starts.shape[0])
                # reduction over the RECORD bytes only, on the device: the
                # payload holds the record spans back to back, so mask
                # with a +1/-1 scatter and cumsum coverage (spans never
                # overlap)
                n = payload.shape[0]
                ones = torch.ones_like(starts, dtype=torch.int32)
                delta = (torch.zeros(n + 1, dtype=torch.int32, device=dev)
                         .index_add_(0, starts, ones)
                         .index_add_(0, ends, -ones))
                covered = torch.cumsum(delta[:-1], 0) > 0
                part_sum = torch.where(covered, payload.to(torch.int64),
                                       0).sum()
                checksum = (checksum + int(part_sum)) % (1 << 32)
        expect = sum(sum(r) for r in records) % (1 << 32)
        got = checksum
        assert got == expect, (got, expect)
        assert nrec == len(records)
        print(f"recordio_device_batches: {nrec} records across {ndev} "
              f"device shards, on-device checksum OK ({got})")


if __name__ == "__main__":
    main()
