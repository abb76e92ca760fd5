# -*- coding: utf-8 -*-
"""Small utilities (phase timers)."""
