"""feed.producer_s_per_chunk (s, program counter): the mean host seconds
the streamed feed's producer thread spent on a chunk (stacking it into the
pinned buffer, waiting for the buffer's last copy, queueing its copy), over
the chunks of the traced window's calls (``pipeline.run_series_pipelined
(producer_seconds=)``)."""


def read(run):
    seconds = run.counters.get("producer_seconds")
    if run.trace is None or not seconds:
        return None
    return sum(seconds) / len(seconds)
