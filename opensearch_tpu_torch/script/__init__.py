"""Scripting: painless-lite (a copy of opensearch_tpu/script): host
contexts interpret the AST, score and filter contexts evaluate it over
dense columns as torch ops."""

from .painless_lite import (ScriptError, execute, parse, run_field_script,
                            run_update_script, validate_device_script)

__all__ = ["ScriptError", "execute", "parse", "run_field_script",
           "run_update_script", "validate_device_script"]
