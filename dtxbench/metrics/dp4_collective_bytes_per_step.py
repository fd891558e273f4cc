"""Bytes of the collectives a control step runs, read from the program's
counter parallel/mesh.COLLECTIVE_BYTES (rank 0's) over the traced steps."""


def read(summary):
    work = (summary or {}).get("work") or {}
    if not work.get("steps") or not work.get("collective_bytes"):
        return None
    return work["collective_bytes"] / work["steps"]
