"""``feed_wait_ms_per_step.train``'s reading in the cell ``fastvqa-train``."""

from portbench.harness.spec import metric_reader

read = metric_reader("feed_wait_ms_per_step.train")
