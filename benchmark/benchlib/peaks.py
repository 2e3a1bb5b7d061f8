"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): the yardstick of every roofline share."""

HBM_BYTES_S = 3.35e12        # device memory bandwidth, bytes a second
