"""Logging with the anim_utils surface the reference uses everywhere
(SURVEY.md §5: `write_message_to_log`, LOG_MODE_DEBUG/INFO/ERROR,
`set_log_mode`, `clear_log`; service config keys `write_log`/`log_level`),
implemented on the standard-library logging module so host applications can
attach their own handlers.
"""

from __future__ import annotations

import logging
from typing import Optional

LOG_MODE_ERROR = 0
LOG_MODE_INFO = 1
LOG_MODE_DEBUG = 2

_LEVEL_FOR_MODE = {LOG_MODE_ERROR: logging.ERROR,
                   LOG_MODE_INFO: logging.INFO,
                   LOG_MODE_DEBUG: logging.DEBUG}

logger = logging.getLogger("morphablegraphs_tpu")
_file_handler: Optional[logging.Handler] = None


def set_log_mode(mode: int):
    """LOG_MODE_* -> logger threshold (reference set_log_mode)."""
    logger.setLevel(_LEVEL_FOR_MODE.get(int(mode), logging.INFO))


def write_message_to_log(message: str, mode: int = LOG_MODE_INFO):
    """reference write_message_to_log(message, LOG_MODE_*)."""
    logger.log(_LEVEL_FOR_MODE.get(int(mode), logging.INFO), message)


def set_log_file(path: Optional[str]):
    """Attach (or with None, detach) a file handler — service config
    `write_log` + log file path (reference activate_file_logging)."""
    global _file_handler
    if _file_handler is not None:
        logger.removeHandler(_file_handler)
        _file_handler.close()
        _file_handler = None
    if path:
        _file_handler = logging.FileHandler(path)
        _file_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(_file_handler)


def clear_log():
    """Truncate the attached log file (reference clear_log)."""
    if _file_handler is not None and hasattr(_file_handler, "baseFilename"):
        with open(_file_handler.baseFilename, "w"):
            pass


def configure_from_service_config(config: dict):
    """Apply `write_log` / `log_file` / `log_level` service-config keys
    (reference examples/config/service.config consumed at server start)."""
    if config.get("write_log"):
        set_log_file(config.get("log_file", "mg_service.log"))
    level = config.get("log_level")
    if level is not None:
        set_log_mode(int(level))
