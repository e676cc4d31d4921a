"""zbuffer_flow_roofline: the least time of every ``zbuffer_bucket_flow``
launch of the traced stretch (bytes and operations counted from the
benchmark's own projected vertices, ``drivers.imitate.flow_least_s``)
over the device time the profiler gives the kernel, in percent. Nothing
when the profiler saw no such kernel, or saw another number of launches
than the benchmark counted."""

KERNEL = "zbuffer_bucket_kernel<true"


def read(rec):
    prof = rec.get("profile")
    if not prof or "flow_least_s" not in rec:
        return None
    names = [n for n in prof["device_ops"] if KERNEL in n]
    dev_s = sum(prof["device_ops"][n] for n in names)
    seen = sum(prof["launches"][n] for n in names)
    if dev_s <= 0 or seen != rec["info"]["flow_launches_counted"]:
        return None
    return 100.0 * rec["flow_least_s"] / dev_s
