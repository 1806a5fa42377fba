"""``download_ms_per_frame.<config>``: device time of the device-to-host
copies in the traced window (the payload's download), per frame traced, in
milliseconds."""


def read(run, part=None):
    n = len(run.traced_frames)
    t = sum(o.end - o.start for o in run.trace.ops if o.cat == "gpu_memcpy" and "DtoH" in o.name)
    return 1e3 * t / n if n and t > 0 else None
