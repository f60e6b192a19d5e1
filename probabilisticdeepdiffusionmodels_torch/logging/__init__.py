from .sink import MetricLogger, RunDir, auto_tags
