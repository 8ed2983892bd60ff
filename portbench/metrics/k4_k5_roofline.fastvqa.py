"""``k4_k5_roofline.train``'s reading in the cell ``fastvqa-train``."""

from portbench.harness.spec import metric_reader

read = metric_reader("k4_k5_roofline.train")
