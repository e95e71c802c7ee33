from .database import RetrievalDatabase  # noqa: F401
from .model import RetrievalHead  # noqa: F401
