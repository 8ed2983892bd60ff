"""``peak_mem_gib.train``'s reading in the cell ``fastvqa-train``."""

from portbench.harness.spec import metric_reader

read = metric_reader("peak_mem_gib.train")
