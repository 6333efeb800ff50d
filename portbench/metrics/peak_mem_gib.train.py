"""The card's peak allocated memory over the training window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start), in GiB."""
LAYER = "device"
SOURCE = "program_counter"
MOVES = "train_triples_per_s"
UNIT = "GiB"


def read(r):
    if r.kind != "train" or not r.peak_window_bytes:
        return None
    return r.peak_window_bytes / 2.0 ** 30
