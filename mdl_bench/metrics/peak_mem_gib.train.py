"""torch.cuda.max_memory_allocated over the window, after a reset at its
start, in GiB."""


def read(record):
    if record.get("kind") != "train" or not record.get("peak_mem_bytes"):
        return None
    return record["peak_mem_bytes"] / 2.0 ** 30
