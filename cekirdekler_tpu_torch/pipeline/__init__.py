"""Device pipelines and the task/device pools (the reference's
``ClPipeline`` and ``Pool.*``); the pipelined compute engines'
``PIPELINE_EVENT`` and ``PIPELINE_DRIVER`` live in ``core/cores.py``."""

from ..core.cores import PIPELINE_DRIVER, PIPELINE_EVENT
from .device_pipeline import ArrayRole, ClPipeline, DevicePipeline, PipelineStage
from .pool import ClDevicePool, ClTask, ClTaskPool, ClTaskType, PoolType

__all__ = [
    "ArrayRole", "ClDevicePool", "ClPipeline", "ClTask", "ClTaskPool", "ClTaskType",
    "DevicePipeline", "PIPELINE_DRIVER", "PIPELINE_EVENT", "PipelineStage", "PoolType",
]
