"""Bag of words: the vocabulary tree and the keyframe database."""

from .vocabulary import Vocabulary, train_vocabulary  # noqa: F401
from .keyframe_db import KeyFrameDB  # noqa: F401
