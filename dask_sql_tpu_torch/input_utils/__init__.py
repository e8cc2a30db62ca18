from .base import BaseInputPlugin
from .convert import InputUtil

__all__ = ["InputUtil", "BaseInputPlugin"]
