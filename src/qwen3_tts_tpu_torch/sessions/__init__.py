"""Session flows for the three modes. Each imports the engine only when
it runs, so this package imports without it."""

from .custom import run_custom_session  # noqa: F401
from .design import run_design_session  # noqa: F401
from .clone import run_clone_manager  # noqa: F401
