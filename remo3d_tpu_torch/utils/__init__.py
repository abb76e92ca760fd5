# -*- coding: utf-8 -*-
"""Small utilities: phase timers and the semi-analytic layered-medium oracle."""
