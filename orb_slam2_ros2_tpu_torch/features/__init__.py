from .frame import FrameFeatures, StereoFrame  # noqa: F401
from .extractor import make_extractor, make_stereo_frontend  # noqa: F401
