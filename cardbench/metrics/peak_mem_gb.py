"""peak_mem_gb: The device allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), in GB.
"""
def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
