"""PyTorch port of flowtrack_tpu/data: image loading, the COCO, PoseTrack
and MPII pose datasets, the flow-pair datasets, and the batch loader that
feeds the train steps and validation."""

from flowtrack_tpu_torch.data.coco import COCODataset  # noqa: F401
from flowtrack_tpu_torch.data.coco_io import COCOIndex  # noqa: F401
from flowtrack_tpu_torch.data.loader import BatchLoader  # noqa: F401
from flowtrack_tpu_torch.data.mpii import MPIIDataset  # noqa: F401
from flowtrack_tpu_torch.data.posetrack import PoseTrackDataset  # noqa: F401
