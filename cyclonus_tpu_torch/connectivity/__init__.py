"""Test harness (reference: pkg/connectivity): dual-write TestCaseState,
the Interpreter (perturb -> wait -> probe -> compare loop), comparison
tables, result aggregation, and reporting."""

from .state import TestCaseState, LabelsDiff
from .stepresult import StepResult
from .comparison import (
    ComparisonTable,
    ComparisonItem,
    COMPARISON_SAME,
    COMPARISON_DIFFERENT,
    COMPARISON_IGNORED,
)
from .result import Result, CombinedResults, Summary
from .interpreter import Interpreter, InterpreterConfig
from .printer import Printer

__all__ = [
    "TestCaseState",
    "LabelsDiff",
    "StepResult",
    "ComparisonTable",
    "ComparisonItem",
    "COMPARISON_SAME",
    "COMPARISON_DIFFERENT",
    "COMPARISON_IGNORED",
    "Result",
    "CombinedResults",
    "Summary",
    "Interpreter",
    "InterpreterConfig",
    "Printer",
]
