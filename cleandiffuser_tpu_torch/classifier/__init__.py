from .base import BaseClassifier, CumRewClassifier, MSEClassifier, QGPOClassifier
