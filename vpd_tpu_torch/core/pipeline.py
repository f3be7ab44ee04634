"""Streaming decode/compute/collect pipeline for batch loops.

The GPU executes asynchronously: the streaming pattern decodes chunk i+1
on a worker thread and collects chunk i-1's host readback while the device
computes chunk i. Counterpart of `vpd_tpu/core/pipeline.py`.
"""

import concurrent.futures


def run_pipelined(chunks, decode, compute, collect):
    """For each chunk: host = decode(chunk); dev = compute(host);
    collect(chunk, dev) — with decode running one chunk ahead and
    collect one chunk behind on worker threads.

    `collect` runs concurrently with later decodes/computes; it must be
    thread-safe with respect to itself only for the final in-flight call
    (collects are otherwise serialized through a 2-thread pool).
    """
    chunks = list(chunks)
    if not chunks:
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        pending = pool.submit(decode, chunks[0])
        in_flight = None  # (chunk, device result)
        collects = []
        for ci, chunk in enumerate(chunks):
            host = pending.result()
            if ci + 1 < len(chunks):
                pending = pool.submit(decode, chunks[ci + 1])
            dev = compute(host)
            if in_flight is not None:
                collects.append(pool.submit(collect, *in_flight))
            in_flight = (chunk, dev)
        for fut in collects:
            fut.result()
        collect(*in_flight)
