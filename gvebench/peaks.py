"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates, full power limit).  A reader finds its card here by
``torch.cuda.get_device_name()``; a card not listed gets no roofline
share."""

PEAKS = {
    # H100 SXM: 80 GB of HBM3 at 3.35 TB/s.
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str):
    peak = PEAKS.get(kind)
    return peak["hbm_bytes_per_s"] if peak else None
