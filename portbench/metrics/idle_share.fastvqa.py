"""``idle_share.train``'s reading in the cell ``fastvqa-train``."""

from portbench.harness.spec import metric_reader

read = metric_reader("idle_share.train")
